"""Observation terms (PyTorch).

Behavioral parity with the reference's jitted obs kernels:
* char obs — envs/ig_char_env.py:581-626
* target obs — envs/ig_parkour/mgdm_dm_util.py:462-519
* heightfield ray obs — envs/ig_parkour/ig_parkour_env.py:139-155 +
  util/terrain_util.py:2049-2083

Layouts are described by an ``ObsLayout`` so agents can locate
non-normalized segments (heightfield + contacts), replacing the reference's
``ret_obs_shapes`` metadata (envs/ig_parkour/ig_parkour_env.py:1054-1244).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from reference.utils import rotation as rot


@dataclasses.dataclass(frozen=True)
class ObsLayout:
    """Named segments of the flat observation vector."""

    names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    normalized: Tuple[bool, ...]

    @property
    def total(self) -> int:
        return sum(self.sizes)

    def slices(self) -> Dict[str, slice]:
        out, off = {}, 0
        for n, s in zip(self.names, self.sizes):
            out[n] = slice(off, off + s)
            off += s
        return out

    def non_norm_mask(self) -> np.ndarray:
        mask = np.zeros(self.total, bool)
        off = 0
        for s, norm in zip(self.sizes, self.normalized):
            if not norm:
                mask[off:off + s] = True
            off += s
        return mask


def compute_char_obs(root_pos, root_rot, root_vel, root_ang_vel, joint_rot,
                     dof_vel, key_pos, global_obs: bool,
                     root_height_obs: bool) -> torch.Tensor:
    """Proprioceptive character observation (heading-local by default)."""
    heading_inv = rot.calc_heading_quat_inv(root_rot)
    if global_obs:
        root_rot_obs = rot.quat_to_tan_norm(root_rot)
        root_vel_obs = root_vel
        root_ang_vel_obs = root_ang_vel
    else:
        root_rot_obs = rot.quat_to_tan_norm(rot.quat_mul(heading_inv, root_rot))
        root_vel_obs = rot.quat_rotate(heading_inv, root_vel)
        root_ang_vel_obs = rot.quat_rotate(heading_inv, root_ang_vel)

    joint_obs = rot.quat_to_tan_norm(joint_rot)
    joint_obs = joint_obs.flatten(-2)

    parts = [root_rot_obs, root_vel_obs, root_ang_vel_obs, joint_obs, dof_vel]

    if key_pos.shape[-2] > 0:
        kp = key_pos - root_pos[..., None, :]
        if not global_obs:
            kp = rot.quat_rotate(heading_inv[..., None, :], kp)
        parts.append(kp.flatten(-2))

    if root_height_obs:
        parts = [root_pos[..., 2:3]] + parts

    return torch.cat(parts, dim=-1)


def compute_tar_obs(ref_root_pos, ref_root_rot, tar_root_pos, tar_root_rot,
                    tar_joint_rot, tar_key_pos, global_obs: bool) -> torch.Tensor:
    """Future target-frame observation relative to the current root.

    Inputs carry a steps axis: tar_* are (..., S, ...).
    """
    root_pos_obs = tar_root_pos - ref_root_pos[..., None, :]
    if not global_obs:
        heading_inv = rot.calc_heading_quat_inv(ref_root_rot)[..., None, :]
        root_pos_obs = rot.quat_rotate(heading_inv, root_pos_obs)
        tar_root_rot = rot.quat_mul(heading_inv.expand(tar_root_rot.shape),
                                    tar_root_rot)

    rot_obs = rot.quat_to_tan_norm(tar_root_rot)
    joint_obs = rot.quat_to_tan_norm(tar_joint_rot)
    joint_obs = joint_obs.flatten(-2)

    parts = [root_pos_obs, rot_obs, joint_obs]
    if tar_key_pos.shape[-2] > 0:
        kp = tar_key_pos - tar_root_pos[..., None, :]
        if not global_obs:
            kp = rot.quat_rotate(heading_inv[..., None, :], kp)
            kp = kp + root_pos_obs[..., None, :]
        parts.append(kp.flatten(-2))
    obs = torch.cat(parts, dim=-1)
    return obs.flatten(-2)


def num_ray_points(cfg) -> int:
    from reference.envs import perception
    return perception.num_points(cfg)


def compute_hf_obs(hf_batch: torch.Tensor, min_point: torch.Tensor,
                   dxdy: torch.Tensor, terrain_idx: torch.Tensor,
                   points_xy: torch.Tensor, root_pos: torch.Tensor,
                   min_h: float, max_h: float) -> torch.Tensor:
    """Per-env nearest-cell heightfield lookups relative to root height.

    hf_batch: (M, H, W); terrain_idx: (N,) selects each env's terrain;
    points_xy: (N, P, 2). Cells are found by rounding half to even.
    """
    mp = min_point[terrain_idx][..., None, :]
    inds = torch.round((points_xy - mp) / dxdy).long()
    h_dim, w_dim = hf_batch.shape[-2:]
    h = hf_batch[terrain_idx[..., None],
                 torch.clamp(inds[..., 0], 0, h_dim - 1),
                 torch.clamp(inds[..., 1], 0, w_dim - 1)]
    rel = h - root_pos[..., 2:3]
    return torch.clamp(rel, min_h, max_h)
