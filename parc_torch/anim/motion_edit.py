"""Motion editing: mirroring, hesitation removal and terrain-from-motion,
the part of the clip-processing toolbox that kin-gen, augmentation and the
dataset stage use.

Reference parity: zmotion_editing_tools/motion_edit_lib.py:291-1319
(mirror :514-610, remove_hesitation :1242, terrain-from-motion :227-290).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from parc_torch.anim import char_model as cm
from parc_torch.anim import motion_data as md
from parc_torch.utils import rotation as rot


def _mirror_pairs(model: cm.CharModel) -> List[Tuple[int, int]]:
    """(body_i, body_j) pairs swapped by a left-right mirror."""
    pairs = []
    for i, name in enumerate(model.body_names):
        if name.startswith("left_"):
            other = "right_" + name[len("left_"):]
            if other in model.body_names:
                pairs.append((i, model.body_names.index(other)))
    return pairs


def flip_motion_about_xz(model: cm.CharModel, frames34: torch.Tensor,
                         contacts: Optional[torch.Tensor] = None):
    """Mirror a motion about the XZ plane (left-right body swap).

    Rotation mirroring: conjugation by diag(1,-1,1) maps an exp-map
    (ex, ey, ez) -> (-ex, ey, -ez); root y negates.
    """
    frames34 = torch.as_tensor(frames34, device=model.device)
    flip = torch.tensor([-1.0, 1.0, -1.0], device=frames34.device)
    root_pos = frames34[..., 0:3] * -flip
    root_em = frames34[..., 3:6] * flip

    # per-joint exp maps -> mirror -> swap left/right -> back to dof
    em = cm.joint_exp_maps(model, frames34[..., 6:]) * flip
    perm = np.arange(model.num_bodies - 1)
    cperm = np.arange(model.num_bodies)
    for i, j in _mirror_pairs(model):
        perm[i - 1], perm[j - 1] = perm[j - 1], perm[i - 1]
        cperm[i], cperm[j] = cperm[j], cperm[i]
    dof = cm.project_to_dof(model, em[..., torch.as_tensor(perm), :])

    out = torch.cat([root_pos, root_em, dof], dim=-1)
    if contacts is not None:
        contacts = torch.as_tensor(contacts)[..., torch.as_tensor(cperm)]
    return out, contacts


def flip_terrain_about_xz(t: md.HostTerrain) -> md.HostTerrain:
    """Mirror a heightfield about the XZ plane (flip the y/col axis)."""
    max_y = t.min_point[1] + (t.hf.shape[1] - 1) * t.dxdy[1]
    return md.HostTerrain(
        hf=t.hf[:, ::-1].copy(),
        min_point=np.asarray([t.min_point[0], -max_y]),
        dxdy=t.dxdy.copy(),
        hf_mask=None if t.hf_mask is None else t.hf_mask[:, ::-1].copy(),
        hf_maxmin=None if t.hf_maxmin is None
        else t.hf_maxmin[:, ::-1].copy())


def remove_hesitation_frames(frames34: np.ndarray,
                             contacts: Optional[np.ndarray],
                             min_root_vel: float = 0.08,
                             fps: float = 30.0,
                             window: int = 15):
    """Drop stretches where the character barely moves (reference:
    zmotion_editing_tools/motion_edit_lib.py:1242). Host numpy."""
    frames34 = np.asarray(frames34)
    vel = np.linalg.norm(np.diff(frames34[:, 0:2], axis=0), axis=-1) * fps
    vel = np.concatenate([vel, vel[-1:]])
    slow = vel < min_root_vel
    # only drop runs longer than `window`, keeping the first few frames
    keep = np.ones(len(frames34), bool)
    run_start = None
    for i, s in enumerate(slow):
        if s and run_start is None:
            run_start = i
        elif not s and run_start is not None:
            if i - run_start > window:
                keep[run_start + window // 3:i] = False
            run_start = None
    if run_start is not None and len(slow) - run_start > window:
        keep[run_start + window // 3:] = False
    out_c = None if contacts is None else np.asarray(contacts)[keep]
    return frames34[keep], out_c


def terrain_from_motion(model: cm.CharModel, frames34: np.ndarray,
                        dx: float = 0.4, padding: float = 1.0
                        ) -> md.HostTerrain:
    """Create a flat-floor terrain sized to a motion's footprint, with the
    floor at the motion's minimum body height (FK on ``model``'s device)."""
    frames34 = torch.as_tensor(np.asarray(frames34, np.float32),
                               device=model.device)
    root_pos = frames34[..., 0:3]
    root_rot = rot.exp_map_to_quat(frames34[..., 3:6])
    joint_rot = cm.dof_to_rot(model, frames34[..., 6:])
    body_pos, _ = cm.forward_kinematics(model, root_pos, root_rot, joint_rot)
    pts = body_pos.reshape(-1, 3).cpu().numpy()
    lo = pts[:, 0:2].min(0) - padding
    hi = pts[:, 0:2].max(0) + padding
    dims = np.maximum(np.ceil((hi - lo) / dx).astype(int) + 1, 4)
    floor = float(pts[:, 2].min()) - 0.05
    return md.HostTerrain(
        hf=np.full((dims[0], dims[1]), floor, np.float32),
        min_point=lo.astype(np.float32),
        dxdy=np.asarray([dx, dx], np.float32))
