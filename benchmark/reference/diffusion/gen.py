"""MDM inference: world-frame <-> canonical-frame bridging + generation.

``gen_mdm_motion`` (reference: diffusion/gen_util.py:36-226): canonicalize
the last prev frames to the heading frame, sample the local heightfield
from the world terrain, condition on an xy target direction, run the
sampler, and un-canonicalize the result back to world coordinates.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from reference.anim import char_model as cm
from reference.diffusion import sampler as sampler_lib
from reference.diffusion.mdm import MDM, MDMState
from reference.utils import rotation as rot
from reference.utils import terrain as terrain_lib


@dataclasses.dataclass(frozen=True)
class GenSettings:
    """Reference: diffusion/gen_util.py:12-34 (MDMGenSettings)."""

    ddim_stride: int = 5
    guidance_scale: float = 1.0
    use_ema: bool = True
    # condition on the prev-state frames (reference MDMGenSettings
    # use_prev_state, gen_util.py:13). False drops the prev-state tokens
    # from attention entirely — the prev frames then only anchor the
    # canonical frame. The reference uses this for the first window of an
    # autoregressive chain (mdm_path.py:149-161).
    use_prev_state: bool = True
    # optional gradient/hf guidance (parc_torch.diffusion.guidance
    # GuidanceParams); None disables
    guidance: object = None


def features_from_frames34(mdm: MDM, frames34: torch.Tensor,
                           contacts: torch.Tensor) -> torch.Tensor:
    """34-D frames + contacts -> 91-D features (in the frames' own
    coordinate frame)."""
    model = mdm.model
    root_pos = frames34[..., 0:3]
    root_rot = rot.exp_map_to_quat(frames34[..., 3:6])
    joint_rot = cm.dof_to_rot(model, frames34[..., 6:])
    body_pos, _ = cm.forward_kinematics(model, root_pos, root_rot, joint_rot)
    joint_pos = body_pos[..., 1:, :] - root_pos[..., None, :]
    return torch.cat([
        root_pos, frames34[..., 3:6],
        joint_pos.reshape(joint_pos.shape[:-2] + (-1,)),
        frames34[..., 6:], contacts], dim=-1)


def frames34_from_features(mdm: MDM, feats: torch.Tensor):
    """91-D features -> (frames34, contacts)."""
    f = sampler_lib.split_features(mdm.model, feats)
    frames34 = torch.cat([f["root_pos"], f["root_rot"], f["dof"]], dim=-1)
    return frames34, f["contacts"]


def canonicalize(frames34: torch.Tensor, canon_xy, canon_z, canon_heading):
    """World 34-D frames -> canonical frame of (xy, z, heading)."""
    pos = frames34[..., 0:3] - torch.cat(
        [canon_xy, canon_z[..., None]], -1)[..., None, :]
    xy = rot.rotate_2d_vec(pos[..., 0:2], -canon_heading[..., None])
    em = rot.quat_to_exp_map(rot.quat_mul(
        rot.heading_to_quat(-canon_heading)[..., None, :],
        rot.exp_map_to_quat(frames34[..., 3:6])))
    return torch.cat([xy, pos[..., 2:3], em, frames34[..., 6:]], dim=-1)


def uncanonicalize(frames34: torch.Tensor, canon_xy, canon_z, canon_heading):
    """Canonical 34-D frames -> world frame."""
    pos = frames34[..., 0:3]
    xy = rot.rotate_2d_vec(pos[..., 0:2], canon_heading[..., None])
    em = rot.quat_to_exp_map(rot.quat_mul(
        rot.heading_to_quat(canon_heading)[..., None, :],
        rot.exp_map_to_quat(frames34[..., 3:6])))
    return torch.cat([xy + canon_xy[..., None, :],
                      pos[..., 2:3] + canon_z[..., None, None],
                      em, frames34[..., 6:]], dim=-1)


def sample_local_hf(mdm: MDM, terrain: terrain_lib.Terrain, canon_xy,
                    canon_z, canon_heading,
                    terrain_idx: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Canonical 31x31 local heightfield from a world terrain, by
    nearest-cell indexing.

    ``terrain`` is either one world terrain shared by every batch row
    (``hf (H, W)``) or a stack of terrains (``hf (R, H, W)``,
    ``min_point (R, 2)`` or shared ``(2,)``) with ``terrain_idx (B,)``
    mapping each row to its terrain (the batched kin-gen path)."""
    scfg = mdm.scfg
    pts = sampler_lib._local_hf_points(scfg, canon_xy, canon_heading)
    hf_t = terrain.hf
    mp = terrain.min_point
    if hf_t.dim() == 3:
        if terrain_idx is None:
            raise ValueError("a stacked terrain needs terrain_idx")
        if mp.dim() == 2:
            mp = mp[terrain_idx][..., None, None, :]
    inds = torch.round((pts - mp) / terrain.dxdy).long()
    dims = torch.as_tensor(hf_t.shape[-2:], device=inds.device)
    inds = torch.minimum(torch.clamp(inds, min=0), dims - 1)
    if hf_t.dim() == 3:
        hf = hf_t[terrain_idx[:, None, None], inds[..., 0], inds[..., 1]]
    else:
        hf = hf_t[inds[..., 0], inds[..., 1]]
    return torch.clamp(hf - canon_z[..., None, None], -scfg.max_h,
                       scfg.max_h)


def gen_mdm_motion(mdm: MDM, state: MDMState, generator: torch.Generator,
                   prev_frames34: torch.Tensor, prev_contacts: torch.Tensor,
                   terrain: terrain_lib.Terrain, target_xy: torch.Tensor,
                   settings: GenSettings = GenSettings(),
                   prev_state_mask=None,
                   terrain_idx: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None):
    """Generate the next 15-frame window in world coordinates.

    Args:
      generator: draws the sampler's initial noise (on the MDM's device).
      prev_frames34: (B, num_prev, 34) world-frame conditioning frames
        (last one is the canonical frame).
      prev_contacts: (B, num_prev, num_bodies).
      terrain: world terrain to condition on — one shared terrain, or a
        stacked ``hf (R, H, W)`` terrain with ``terrain_idx (B,)``
        mapping rows to terrains (see :func:`sample_local_hf`).
      target_xy: (B, 2) world-frame target position.
      prev_state_mask: optional per-env (B,) {0,1} mask overriding
        settings.use_prev_state (reference: mgdm_env.py:644-645).
      noise: optional initial x_T of the DDIM sampler.

    Returns:
      (frames34 (B, 15, 34), contacts (B, 15, num_bodies)) world-frame
      window; contacts rounded to {0, 1}.
    """
    scfg = mdm.scfg
    canon = prev_frames34[:, -1]
    canon_xy = canon[:, 0:2]
    canon_z = canon[:, 2]
    canon_heading = rot.calc_heading(rot.exp_map_to_quat(canon[:, 3:6]))

    prev_canon = canonicalize(prev_frames34, canon_xy, canon_z,
                              canon_heading)
    prev_feats = features_from_frames34(mdm, prev_canon, prev_contacts)
    hf = sample_local_hf(mdm, terrain, canon_xy, canon_z, canon_heading,
                         terrain_idx=terrain_idx)

    target_xy_canon = rot.rotate_2d_vec(target_xy - canon_xy, -canon_heading)
    norm = torch.linalg.norm(target_xy_canon, dim=-1, keepdim=True)
    target_dir = torch.where(norm > scfg.target_dir_len_eps,
                             target_xy_canon / torch.clamp(norm, min=1e-6),
                             torch.zeros_like(target_xy_canon))

    feats = mdm.ddim_sample(state, generator, prev_feats, hf, target_dir,
                            stride=settings.ddim_stride,
                            guidance_scale=settings.guidance_scale,
                            use_ema=settings.use_ema,
                            guidance=settings.guidance,
                            target_xy=target_xy_canon,
                            use_prev_state=(settings.use_prev_state
                                            if prev_state_mask is None
                                            else prev_state_mask),
                            noise=noise)
    frames34_c, contacts = frames34_from_features(mdm, feats)
    frames34 = uncanonicalize(frames34_c, canon_xy, canon_z, canon_heading)
    return frames34, torch.clamp(torch.round(contacts), 0.0, 1.0)
