"""Motion library: batched reference-motion playback on device.

Loads a set of motion clips (plus per-motion terrains) into flat tensors
and provides vectorized frame sampling with slerp blending, CLAMP/WRAP
looping, and weighted motion sampling. Terrains are edge-padded to common
dimensions so a per-motion terrain lookup is one index.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from reference import resolve_device
from reference.anim import char_model as cm
from reference.anim import motion_data as md
from reference.utils import rotation as rot

LOOP_CLAMP, LOOP_WRAP = 0, 1


@dataclasses.dataclass
class MotionFrame:
    """A batch of sampled motion frames."""

    root_pos: torch.Tensor      # (..., 3)
    root_rot: torch.Tensor      # (..., 4)
    root_vel: torch.Tensor      # (..., 3)
    root_ang_vel: torch.Tensor  # (..., 3)
    joint_rot: torch.Tensor     # (..., J-1, 4)
    dof_vel: torch.Tensor       # (..., D)
    contacts: torch.Tensor      # (..., B)


@dataclasses.dataclass
class MotionLib:
    # concatenated per-frame arrays (F = total frames over all motions)
    frame_root_pos: torch.Tensor      # (F, 3)
    frame_root_rot: torch.Tensor      # (F, 4)
    frame_root_vel: torch.Tensor      # (F, 3)
    frame_root_ang_vel: torch.Tensor  # (F, 3)
    frame_joint_rot: torch.Tensor     # (F, J-1, 4)
    frame_dof_vel: torch.Tensor       # (F, D)
    frame_contacts: torch.Tensor      # (F, B)
    # per-motion metadata
    start_idx: torch.Tensor       # (M,) int64
    num_frames: torch.Tensor      # (M,) int64
    lengths: torch.Tensor         # (M,) float  (num_frames-1)/fps
    fps: torch.Tensor             # (M,)
    loop_modes: torch.Tensor      # (M,) int64
    weights: torch.Tensor         # (M,) sampling weights (normalized)
    root_pos_delta: torch.Tensor  # (M, 3) xy displacement per loop (WRAP)
    # per-motion terrain, padded to common dims
    terrain_hf: torch.Tensor         # (M, Ht, Wt)
    terrain_maxmin: torch.Tensor     # (M, Ht, Wt, 2) augmentation max/min
    terrain_min_point: torch.Tensor  # (M, 2)
    terrain_dxdy: torch.Tensor       # (2,)

    @property
    def num_motions(self) -> int:
        return self.start_idx.shape[0]

    @property
    def device(self) -> torch.device:
        return self.frame_root_pos.device


def build_motion_lib(model: cm.CharModel,
                     motions: Sequence[md.MotionData],
                     weights: Optional[Sequence[float]] = None,
                     device="cuda") -> MotionLib:
    """Assemble a MotionLib from host motion clips.

    Velocities are forward differences scaled by fps with the last frame
    repeated; angular velocity is the exp-map of the frame-to-frame
    world-frame quaternion difference.
    """
    dev = resolve_device(device)
    model = model.to(dev)
    num_bodies = model.num_bodies
    rp, rr, rv, rav, jr, dv, ct = [], [], [], [], [], [], []
    starts, counts, lengths, fpss, loops, deltas = [], [], [], [], [], []
    hfs, maxmins, minpts, dxdys = [], [], [], []
    off = 0
    for m in motions:
        frames = torch.as_tensor(np.asarray(m.frames, np.float32), device=dev)
        fps = float(m.fps)
        n = frames.shape[0]
        root_pos = frames[:, 0:3]
        root_rot = rot.exp_map_to_quat(frames[:, 3:6])
        joint_rot = rot.quat_pos(cm.dof_to_rot(model, frames[:, 6:]))

        root_vel = fps * (root_pos[1:] - root_pos[:-1])
        root_vel = torch.cat([root_vel, root_vel[-1:]], 0)
        drot = rot.quat_diff(root_rot[:-1], root_rot[1:])
        root_ang_vel = fps * rot.quat_to_exp_map(drot)
        root_ang_vel = torch.cat([root_ang_vel, root_ang_vel[-1:]], 0)
        dof_vel = cm.compute_frame_dof_vel(model, joint_rot, 1.0 / fps)

        contacts = (torch.as_tensor(np.asarray(m.contacts, np.float32),
                                    device=dev)
                    if m.contacts is not None
                    else torch.zeros((n, num_bodies), device=dev))

        rp.append(root_pos); rr.append(root_rot); rv.append(root_vel)
        rav.append(root_ang_vel); jr.append(joint_rot); dv.append(dof_vel)
        ct.append(contacts)
        starts.append(off); counts.append(n)
        lengths.append((n - 1) / fps); fpss.append(fps)
        loops.append(md.LOOP_MODES[m.loop_mode])
        delta = (root_pos[-1] - root_pos[0]).cpu().numpy()
        delta[2] = 0.0
        deltas.append(delta)
        off += n
        if m.terrain is not None:
            h = np.asarray(m.terrain.hf, np.float32)
            hfs.append(h)
            mm = (np.asarray(m.terrain.hf_maxmin, np.float32)
                  if m.terrain.hf_maxmin is not None
                  else np.stack([h + 3.0, h - 3.0], -1))
            maxmins.append(mm)
            minpts.append(np.asarray(m.terrain.min_point[:2], np.float32))
            dxdys.append(np.asarray(m.terrain.dxdy[:2], np.float32))
        else:
            hfs.append(np.zeros((2, 2), np.float32))
            maxmins.append(np.stack([np.full((2, 2), 3.0, np.float32),
                                     np.full((2, 2), -3.0, np.float32)], -1))
            minpts.append(np.asarray([-100.0, -100.0], np.float32))
            dxdys.append(np.asarray([0.4, 0.4], np.float32))

    # pad terrains to common dims (edge padding keeps borders walkable)
    ht = max(h.shape[0] for h in hfs)
    wt = max(h.shape[1] for h in hfs)
    hf_pad = np.stack([
        np.pad(h, ((0, ht - h.shape[0]), (0, wt - h.shape[1])), mode="edge")
        for h in hfs])
    mm_pad = np.stack([
        np.pad(m_, ((0, ht - m_.shape[0]), (0, wt - m_.shape[1]), (0, 0)),
               mode="edge")
        for m_ in maxmins])

    w = (np.asarray(weights, np.float64) if weights is not None
         else np.ones(len(motions)))
    w = w / w.sum()

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    return MotionLib(
        frame_root_pos=torch.cat(rp),
        frame_root_rot=torch.cat(rr),
        frame_root_vel=torch.cat(rv),
        frame_root_ang_vel=torch.cat(rav),
        frame_joint_rot=torch.cat(jr),
        frame_dof_vel=torch.cat(dv),
        frame_contacts=torch.cat(ct),
        start_idx=i64(starts),
        num_frames=i64(counts),
        lengths=f32(lengths),
        fps=f32(fpss),
        loop_modes=i64(loops),
        weights=f32(w),
        root_pos_delta=f32(np.stack(deltas)),
        terrain_hf=f32(hf_pad),
        terrain_maxmin=f32(mm_pad),
        terrain_min_point=f32(np.stack(minpts)),
        terrain_dxdy=f32(dxdys[0]),
    )


def load_motion_lib(model: cm.CharModel, files: Sequence[str],
                    weights: Optional[Sequence[float]] = None,
                    device="cuda") -> MotionLib:
    """A MotionLib of the clips in ``files`` (``.npz``)."""
    return build_motion_lib(
        model, [md.load_motion_data(f) for f in files], weights, device)


# ---------------------------------------------------------------------------
# Sampling functions
# ---------------------------------------------------------------------------


def sample_motions(lib: MotionLib, generator: torch.Generator, n: int,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """n motion ids drawn with probability proportional to ``weights``.

    ``generator`` lives on the library's device."""
    w = lib.weights if weights is None else weights
    return torch.multinomial(torch.clamp(w, min=1e-12), n, replacement=True,
                             generator=generator)


def sample_time(lib: MotionLib, generator: torch.Generator,
                motion_ids: torch.Tensor,
                truncate_time: Optional[float] = None) -> torch.Tensor:
    phase = torch.rand(motion_ids.shape, generator=generator,
                       device=motion_ids.device)
    length = lib.lengths[motion_ids]
    if truncate_time is not None:
        length = torch.clamp(length - truncate_time, min=0.0)
    return phase * length


def calc_phase(lib: MotionLib, motion_ids: torch.Tensor,
               times: torch.Tensor) -> torch.Tensor:
    length = lib.lengths[motion_ids]
    phase = times / length
    wrap = lib.loop_modes[motion_ids] == LOOP_WRAP
    phase = torch.where(wrap, phase - torch.floor(phase), phase)
    return torch.clamp(phase, 0.0, 1.0)


def calc_frame_blend(lib: MotionLib, motion_ids: torch.Tensor,
                     times: torch.Tensor):
    num_frames = lib.num_frames[motion_ids]
    phase = calc_phase(lib, motion_ids, times)
    fidx = phase * (num_frames - 1).to(phase.dtype)
    idx0 = torch.floor(fidx).long()
    idx0 = torch.minimum(idx0, num_frames - 1)
    idx1 = torch.minimum(idx0 + 1, num_frames - 1)
    blend = fidx - idx0.to(phase.dtype)
    start = lib.start_idx[motion_ids]
    return start + idx0, start + idx1, blend


def _loop_offset(lib: MotionLib, motion_ids: torch.Tensor,
                 times: torch.Tensor) -> torch.Tensor:
    wrap = lib.loop_modes[motion_ids] == LOOP_WRAP
    cycles = torch.floor(times / lib.lengths[motion_ids])
    delta = lib.root_pos_delta[motion_ids]
    return torch.where(wrap[..., None], cycles[..., None] * delta,
                       torch.zeros_like(delta))


def calc_motion_frame(lib: MotionLib, motion_ids: torch.Tensor,
                      times: torch.Tensor) -> MotionFrame:
    """Sample blended motion frames at arbitrary times.

    Positions/rotations are slerp-blended; velocities come from the earlier
    frame and contacts are blended linearly."""
    i0, i1, blend = calc_frame_blend(lib, motion_ids, times)
    b = blend[..., None]
    root_pos = (1.0 - b) * lib.frame_root_pos[i0] + b * lib.frame_root_pos[i1]
    root_rot = rot.slerp(lib.frame_root_rot[i0], lib.frame_root_rot[i1], blend)
    joint_rot = rot.slerp(lib.frame_joint_rot[i0], lib.frame_joint_rot[i1], b)
    contacts = (1.0 - b) * lib.frame_contacts[i0] + b * lib.frame_contacts[i1]
    root_pos = root_pos + _loop_offset(lib, motion_ids, times)
    return MotionFrame(
        root_pos=root_pos, root_rot=root_rot,
        root_vel=lib.frame_root_vel[i0],
        root_ang_vel=lib.frame_root_ang_vel[i0],
        joint_rot=joint_rot, dof_vel=lib.frame_dof_vel[i0],
        contacts=contacts)


def frames_34d(model: cm.CharModel, frame: MotionFrame) -> torch.Tensor:
    """MotionFrame -> the interchange 34-D representation."""
    return torch.cat([
        frame.root_pos, rot.quat_to_exp_map(frame.root_rot),
        cm.rot_to_dof(model, frame.joint_rot)], dim=-1)


def append_terrain_slot(lib: MotionLib, terrain) -> MotionLib:
    """``lib`` with one zero-weight dummy motion appended whose terrain is
    ``terrain`` (a ``utils.terrain.Terrain`` with an (H, W) hf).

    The parkour env pins its MDM-driven envs to this slot, so the per-motion
    terrain lookup and fail-rate statistics serve them too, while their
    reference frames come from the generated window buffer. Every terrain
    is edge-padded to the larger of the two grids; the slot's max/min
    bounds are its heights +- 3 m, and its two frames are identity poses
    that are never sampled (weight 0)."""
    dev = lib.device
    hf_new = terrain.hf.detach().cpu().numpy().astype(np.float32)
    old_hf = lib.terrain_hf.cpu().numpy()
    old_mm = lib.terrain_maxmin.cpu().numpy()
    ht = max(old_hf.shape[1], hf_new.shape[0])
    wt = max(old_hf.shape[2], hf_new.shape[1])

    def pad(h):
        widths = ((0, ht - h.shape[0]), (0, wt - h.shape[1]))
        return np.pad(h, widths + ((0, 0),) * (h.ndim - 2), mode="edge")

    mm_new = np.stack([hf_new + 3.0, hf_new - 3.0], -1)
    hf_stack = np.stack([pad(h) for h in old_hf] + [pad(hf_new)])
    mm_stack = np.stack([pad(m) for m in old_mm] + [pad(mm_new)])

    two = 2  # dummy frames

    def pad_frames(x, identity=False):
        z = torch.zeros((two,) + x.shape[1:], dtype=x.dtype, device=dev)
        if identity:
            z[..., 3] = 1.0
        return torch.cat([x, z])

    def append(x, v, dtype=torch.float32):
        return torch.cat([x, torch.as_tensor(np.asarray(v), dtype=dtype,
                                             device=dev)])

    f = int(lib.num_frames.sum())
    return dataclasses.replace(
        lib,
        frame_root_pos=pad_frames(lib.frame_root_pos),
        frame_root_rot=pad_frames(lib.frame_root_rot, identity=True),
        frame_root_vel=pad_frames(lib.frame_root_vel),
        frame_root_ang_vel=pad_frames(lib.frame_root_ang_vel),
        frame_joint_rot=pad_frames(lib.frame_joint_rot, identity=True),
        frame_dof_vel=pad_frames(lib.frame_dof_vel),
        frame_contacts=pad_frames(lib.frame_contacts),
        start_idx=append(lib.start_idx, [f], torch.int64),
        num_frames=append(lib.num_frames, [two], torch.int64),
        lengths=append(lib.lengths, [np.float32(1.0 / 30.0)]),
        fps=append(lib.fps, [30.0]),
        loop_modes=append(lib.loop_modes, [LOOP_CLAMP], torch.int64),
        weights=append(lib.weights, [0.0]),
        root_pos_delta=torch.cat([lib.root_pos_delta,
                                  torch.zeros((1, 3), device=dev)]),
        terrain_hf=torch.as_tensor(hf_stack, device=dev),
        terrain_maxmin=torch.as_tensor(mm_stack, device=dev),
        terrain_min_point=torch.cat([
            lib.terrain_min_point,
            terrain.min_point.to(dev, torch.float32).reshape(1, 2)]),
    )
