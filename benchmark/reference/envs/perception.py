"""Pluggable terrain-perception point patterns.

The env config selects the local heightfield sample pattern:

* ``HF_RAY``  — cone of rays ahead of the character
  (util/geom_util.py:249-271, the tracker default)
* ``HF_GRID`` — uniform heading-rotated xy grid (util/geom_util.py:210-222)
* ``HF_GRID_C2F`` — coarse-to-fine grid whose spacing grows away from the
  character (util/geom_util.py:224-247)

Each pattern is a static (P, 2) host-numpy table of character-local xy
offsets; per step the env rotates it by the root heading and translates to
the root xy (``sample_points``), then looks heights up via
``obs.compute_hf_obs``.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.utils import rotation as rot

MODES = ("HF_RAY", "HF_GRID", "HF_GRID_C2F")


def cone_pattern(num_behind: int, num_ahead: int, num_left: int,
                 num_right: int, dx: float, angle: float) -> np.ndarray:
    """Cone-of-rays local pattern (reference util/geom_util.py:249-271).

    Ray-major layout: rays ordered from ``-num_left * angle`` to
    ``+num_right * angle``, each a line of ``num_behind + num_ahead + 1``
    samples spaced ``dx`` along the ray.
    """
    t = (np.arange(-num_behind, num_ahead + 1) * dx).astype(np.float32)
    angles = (np.arange(-num_left, num_right + 1) * angle).astype(np.float32)
    px = np.cos(angles)[:, None] * t[None, :]
    py = np.sin(angles)[:, None] * t[None, :]
    return np.stack([px, py], axis=-1).reshape(-1, 2).astype(np.float32)


def grid_pattern(dx: float, dy: float, num_x_neg: int, num_x_pos: int,
                 num_y_neg: int, num_y_pos: int,
                 center=(0.0, 0.0)) -> np.ndarray:
    """Uniform xy grid local pattern (reference util/geom_util.py:210-222).

    x-major layout over ``(num_x_neg + num_x_pos + 1) ×
    (num_y_neg + num_y_pos + 1)`` points.
    """
    xs = center[0] + np.arange(-num_x_neg, num_x_pos + 1) * dx
    ys = center[1] + np.arange(-num_y_neg, num_y_pos + 1) * dy
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel()], axis=-1).astype(np.float32)


def coarse2fine_pattern(dx: float, dy: float, num_x: int, num_y: int,
                        root_x_offset: float, dx_incr_rate: float,
                        dy_incr_rate: float,
                        center=(0.0, 0.0)) -> np.ndarray:
    """Coarse-to-fine grid (reference util/geom_util.py:224-247).

    A uniform ``(2·num_x+1) × (2·num_y+1)`` core whose outer points (beyond
    one cell from the center) shift by a cumulative ``*_incr_rate`` per
    step.  The reference spreads x outward but pulls y *inward* (its y
    increments carry the opposite sign, geom_util.py:240-241) — matched
    here for parity.
    """
    xs = np.linspace(center[0] - dx * num_x, center[0] + dx * num_x,
                     2 * num_x + 1)
    ys = np.linspace(center[1] - dy * num_y, center[1] + dy * num_y,
                     2 * num_y + 1)
    if num_x > 1:
        x_inc = np.cumsum(np.full(num_x - 1, dx_incr_rate))
        xs[num_x + 2:] += x_inc
        xs[:num_x - 1] -= x_inc[::-1]
    if num_y > 1:
        y_inc = np.cumsum(np.full(num_y - 1, dy_incr_rate))
        ys[num_y + 2:] -= y_inc
        ys[:num_y - 1] += y_inc[::-1]
    xs = xs + root_x_offset
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel()], axis=-1).astype(np.float32)


def local_pattern(cfg) -> np.ndarray:
    """Static (P, 2) local xy offsets for an ``EnvConfig``."""
    mode = getattr(cfg, "terrain_obs_mode", "HF_RAY")
    if mode == "HF_RAY":
        return cone_pattern(cfg.ray_points_behind, cfg.ray_points_ahead,
                            cfg.ray_num_side, cfg.ray_num_side,
                            cfg.ray_dx, cfg.ray_angle)
    if mode == "HF_GRID":
        return grid_pattern(cfg.grid_dx, cfg.grid_dy,
                            cfg.grid_num_x_neg, cfg.grid_num_x_pos,
                            cfg.grid_num_y_neg, cfg.grid_num_y_pos)
    if mode == "HF_GRID_C2F":
        return coarse2fine_pattern(cfg.grid_dx, cfg.grid_dy,
                                   cfg.c2f_num_x, cfg.c2f_num_y,
                                   cfg.c2f_root_x_offset,
                                   cfg.c2f_dx_incr_rate,
                                   cfg.c2f_dy_incr_rate)
    raise ValueError(f"unknown terrain_obs_mode {mode!r}; one of {MODES}")


def num_points(cfg) -> int:
    return local_pattern(cfg).shape[0]


def hf_shape(cfg) -> tuple:
    """2-D (rows, cols) layout of the flat hf obs, for the vision
    policies' conv tokenizer (learning/vision_nets.py)."""
    mode = getattr(cfg, "terrain_obs_mode", "HF_RAY")
    if mode == "HF_RAY":
        return (2 * cfg.ray_num_side + 1,
                cfg.ray_points_behind + cfg.ray_points_ahead + 1)
    if mode == "HF_GRID":
        return (cfg.grid_num_x_neg + cfg.grid_num_x_pos + 1,
                cfg.grid_num_y_neg + cfg.grid_num_y_pos + 1)
    if mode == "HF_GRID_C2F":
        return (2 * cfg.c2f_num_x + 1, 2 * cfg.c2f_num_y + 1)
    raise ValueError(f"unknown terrain_obs_mode {mode!r}; one of {MODES}")


def sample_points(root_pos: torch.Tensor, root_rot: torch.Tensor,
                  pattern: torch.Tensor) -> torch.Tensor:
    """World xy sample points: heading-rotate + translate the pattern.

    root_pos (..., 3), root_rot (..., 4), pattern (P, 2) on their device
    → (..., P, 2).
    """
    heading = rot.calc_heading(root_rot)
    c = torch.cos(heading)[..., None]
    s = torch.sin(heading)[..., None]
    px = c * pattern[..., 0] - s * pattern[..., 1]
    py = s * pattern[..., 0] + c * pattern[..., 1]
    return torch.stack([px, py], dim=-1) + root_pos[..., None, 0:2]
