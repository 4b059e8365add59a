"""Rotation-representation conversion for motion frames.

The reference's RotChanger (diffusion/utils/rot_changer.py:8-100) converts
the rotation blocks of a motion frame between representations so the MDM
can be trained on alternatives to the default exp-map dofs (the shipped
configs keep exp-map).

A 34-D frame is [root_pos(3), root_rot exp-map(3), joint dof(28)].
Conversions:
  exp_map  — identity (34-D)
  quat     — root quat(4) + per-joint quat(4 * (J-1))
  tan_norm — root 6-D tan-norm + per-joint 6-D
"""

from __future__ import annotations

import torch

from parc_torch.anim import char_model as cm
from parc_torch.utils import rotation as rot

ROT_TYPES = ("exp_map", "quat", "tan_norm")
_ROT_DIMS = {"exp_map": 3, "quat": 4, "tan_norm": 6}


class RotChanger:
    """Converts frames34 <-> frames with an alternative rot representation."""

    def __init__(self, model: cm.CharModel, rot_type: str = "exp_map"):
        if rot_type not in ROT_TYPES:
            raise ValueError(f"rot_type must be one of {ROT_TYPES}")
        self.model = model
        self.rot_type = rot_type
        self.num_joints = model.num_bodies - 1

    @property
    def frame_dim(self) -> int:
        if self.rot_type == "exp_map":
            return 34
        d = _ROT_DIMS[self.rot_type]
        return 3 + d + d * self.num_joints

    def from_frames34(self, frames34: torch.Tensor) -> torch.Tensor:
        if self.rot_type == "exp_map":
            return frames34
        root_pos = frames34[..., 0:3]
        root_q = rot.exp_map_to_quat(frames34[..., 3:6])
        joint_q = cm.dof_to_rot(self.model, frames34[..., 6:])
        if self.rot_type == "quat":
            enc_root, enc_joint = root_q, joint_q
        else:  # tan_norm
            enc_root = rot.quat_to_tan_norm(root_q)
            enc_joint = rot.quat_to_tan_norm(joint_q)
        flat = enc_joint.reshape(enc_joint.shape[:-2] + (-1,))
        return torch.cat([root_pos, enc_root, flat], dim=-1)

    def to_frames34(self, frames: torch.Tensor) -> torch.Tensor:
        if self.rot_type == "exp_map":
            return frames
        d = _ROT_DIMS[self.rot_type]
        root_pos = frames[..., 0:3]
        enc_root = frames[..., 3:3 + d]
        enc_joint = frames[..., 3 + d:].reshape(
            frames.shape[:-1] + (self.num_joints, d))
        if self.rot_type == "quat":
            root_q = rot.quat_normalize(enc_root)
            joint_q = rot.quat_normalize(enc_joint)
        else:
            root_q = rot.tan_norm_to_quat(enc_root)
            joint_q = rot.tan_norm_to_quat(enc_joint)
        root_em = rot.quat_to_exp_map(root_q)
        dof = cm.rot_to_dof(self.model, joint_q)
        return torch.cat([root_pos, root_em, dof], dim=-1)
