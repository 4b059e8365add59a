"""Heightfield terrain (core): the grid the physics collides against.

Grid conventions:
* ``hf[i, j]`` is the height of the cell whose *center* is at
  ``min_point + (i, j) * dxdy``; points map to cells by rounding.
* ``hf_mask`` marks cells protected from augmentation (touched by a motion).
* ``hf_maxmin[..., 0] / [..., 1]`` are per-cell max/min allowed heights for
  augmentation.

A stacked terrain holds ``hf`` (M, H, W) and ``min_point`` (M, 2); each
env then looks up its own terrain by index.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from parc_torch import resolve_device


@dataclasses.dataclass
class Terrain:
    hf: torch.Tensor          # (H, W) or (M, H, W) float heights
    hf_mask: torch.Tensor     # same shape as hf, bool
    hf_maxmin: torch.Tensor   # hf.shape + (2,) max/min augmentation heights
    min_point: torch.Tensor   # (2,) or (M, 2) world xy of cell (0, 0) center
    dxdy: torch.Tensor        # (2,) cell size

    @property
    def dims(self) -> Tuple[int, int]:
        return self.hf.shape[-2], self.hf.shape[-1]

    @property
    def max_point(self) -> torch.Tensor:
        dims = torch.as_tensor(self.dims, dtype=self.min_point.dtype,
                               device=self.min_point.device)
        return self.min_point + (dims - 1) * self.dxdy


def create_terrain(x_dim: int = 16, y_dim: int = 16, dx: float = 0.4,
                   dy: Optional[float] = None, min_x: float = 0.0,
                   min_y: float = 0.0, height: float = 0.0,
                   device="cuda") -> Terrain:
    dev = resolve_device(device)
    dy = dx if dy is None else dy
    hf = torch.full((x_dim, y_dim), height, dtype=torch.float32, device=dev)
    return Terrain(
        hf=hf,
        hf_mask=torch.zeros((x_dim, y_dim), dtype=torch.bool, device=dev),
        hf_maxmin=torch.stack([hf + 3.0, hf - 3.0], dim=-1),
        min_point=torch.tensor([min_x, min_y], dtype=torch.float32,
                               device=dev),
        dxdy=torch.tensor([dx, dy], dtype=torch.float32, device=dev),
    )


def stack_terrains(terrains: Sequence[Terrain]) -> Terrain:
    """Stack R terrains into one hf (R, H, W) Terrain (edge-padded to the
    largest grid; per-terrain (R, 2) min_point). dxdy must match."""
    dev = terrains[0].hf.device
    dx0 = terrains[0].dxdy.cpu().numpy()
    h = max(int(t.hf.shape[0]) for t in terrains)
    w = max(int(t.hf.shape[1]) for t in terrains)
    hfs, mps = [], []
    for t in terrains:
        if not np.allclose(t.dxdy.cpu().numpy(), dx0):
            raise ValueError("dxdy must match across stacked terrains")
        hf = t.hf.cpu().numpy().astype(np.float32)
        hfs.append(np.pad(hf, [(0, h - hf.shape[0]), (0, w - hf.shape[1])],
                          mode="edge"))
        mps.append(t.min_point.cpu().numpy().astype(np.float32))
    hf = torch.as_tensor(np.stack(hfs), device=dev)
    return Terrain(
        hf=hf, hf_mask=torch.zeros(hf.shape, dtype=torch.bool, device=dev),
        hf_maxmin=torch.stack([hf + 3.0, hf - 3.0], dim=-1),
        min_point=torch.as_tensor(np.stack(mps), device=dev),
        dxdy=torch.as_tensor(dx0, device=dev))


# ---------------------------------------------------------------------------
# Lookups and motion-aware masks
# ---------------------------------------------------------------------------


def get_grid_index(terrain: Terrain, points_xy: torch.Tensor) -> torch.Tensor:
    """Nearest-cell (int64) indices for world xy points, clamped in-bounds
    (round half to even, as numpy and JAX round)."""
    inds = torch.round((points_xy - terrain.min_point) / terrain.dxdy).long()
    hi = torch.as_tensor(terrain.dims, device=inds.device) - 1
    return torch.clamp(inds, min=torch.zeros_like(hi), max=hi)


def compute_hf_mask_inds(terrain: Terrain, body_points: torch.Tensor,
                         pad_cells: int = 1) -> torch.Tensor:
    """Boolean (H, W) mask of cells touched by character body points.

    ``body_points`` is any (..., 3) cloud (e.g. per-frame body positions or
    surface samples over a whole motion). Cells within ``pad_cells`` of a
    touched cell are also marked (reference: util/terrain_util.py:1951-1997).
    """
    mask = torch.zeros(terrain.dims, dtype=torch.bool,
                       device=terrain.hf.device)
    pts = body_points.reshape(-1, 3)
    ij = get_grid_index(terrain, pts[:, 0:2])
    mask[ij[:, 0], ij[:, 1]] = True
    if pad_cells > 0:
        size = 2 * pad_cells + 1
        mask = F.max_pool2d(mask[None, None].float(), size, stride=1,
                            padding=pad_cells)[0, 0] > 0
    return mask


def compute_hf_maxmin(terrain: Terrain, body_points: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      z_buf: float = 3.0, jump_buf: float = 0.8,
                      contact_eps: float = 0.05) -> Terrain:
    """Augmentation bounds (reference: util/terrain_util.py:2017-2047
    compute_hf_extra_vals):

    * free cells may move in [min(terrain) - z_buf, max(body z) + z_buf];
    * cells the motion touched are pinned near their current height;
    * **jump-gap carving**: touched cells the character cleared by at least
      ``jump_buf`` (min body height >= hf + jump_buf) may be carved *down*
      to a gap (hmin = global min - z_buf) and raised only up to
      ``min_body - jump_buf``: augmentation can open a gap under a jump
      but never put terrain into the flight path.
    """
    pts = body_points.reshape(-1, 3)
    if mask is None:
        mask = compute_hf_mask_inds(terrain, pts)
    h, w = terrain.dims
    ij = get_grid_index(terrain, pts[:, 0:2])
    # min body height per cell (inf where never visited)
    min_body = torch.full((h * w,), float("inf"), dtype=terrain.hf.dtype,
                          device=terrain.hf.device)
    min_body.scatter_reduce_(0, ij[:, 0] * w + ij[:, 1],
                             pts[:, 2].to(min_body.dtype), reduce="amin")
    # spread over the 3x3 neighbourhood (max-pooling pads with -inf)
    min_body = -F.max_pool2d(-min_body.reshape(1, 1, h, w), 3, stride=1,
                             padding=1)[0, 0]

    hf = terrain.hf
    max_free = torch.max(pts[:, 2]) + z_buf
    min_free = torch.min(hf) - z_buf
    hmax = torch.where(mask, hf + contact_eps, max_free)
    hmin = torch.where(mask, hf - contact_eps, min_free)
    jump = mask & ((min_body - hf) >= jump_buf)
    hmax = torch.where(jump, min_body - jump_buf, hmax)
    hmin = torch.where(jump, min_free, hmin)
    return dataclasses.replace(terrain, hf_mask=mask,
                               hf_maxmin=torch.stack([hmax, hmin], dim=-1))
