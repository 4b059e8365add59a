"""Motion editing. So far only :func:`terrain_from_motion`, which the
dataset stage needs; the editing ops come with the kin-gen slice."""

from __future__ import annotations

import numpy as np
import torch

from parc_torch.anim import char_model as cm
from parc_torch.anim import motion_data as md
from parc_torch.utils import rotation as rot


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
