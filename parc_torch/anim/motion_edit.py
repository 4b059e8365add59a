"""Motion editing operations.

Mirror / resample / blend / slice / contact labeling / hesitation removal /
terrain-from-motion / spatial edits / motion-matching transitions — the
clip-processing toolbox of kin-gen, augmentation, the dataset stage and
the studio.

Functions that take a ``CharModel`` run on its device; the host-numpy
edits without one (rotate, re-heading, alignment) do their few quaternion
products with torch on the CPU, in float32 as the JAX package does.

Reference parity: zmotion_editing_tools/motion_edit_lib.py:291-1319
(mirror :514-610, fps resample :1130, blend/stitch :326-433, contacts from
geometry :612-787, remove_hesitation :1242, terrain-from-motion :227-290).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from torch.nn import functional as F

from parc_torch.anim import char_model as cm
from parc_torch.anim import motion_data as md
from parc_torch.utils import rotation as rot
from parc_torch.utils import terrain as terrain_lib


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


# ---------------------------------------------------------------------------
# Temporal ops
# ---------------------------------------------------------------------------


def _on(model: cm.CharModel, frames34) -> torch.Tensor:
    """Frames as float32 on the model's device."""
    if not isinstance(frames34, torch.Tensor):
        frames34 = np.ascontiguousarray(frames34, np.float32)
    return torch.as_tensor(frames34, dtype=torch.float32,
                           device=model.device)


def _linspace(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace`` in float32 bit for bit, as XLA compiles it:
    ``start * (1 - i * c) + i * (stop * c)`` with ``c = 1 / (num - 1)`` and
    the last point ``stop``, so the frame indices floored from it are the
    same as the JAX package's."""
    if num <= 1:
        return np.full((num,), start, np.float32)
    c = np.float32(1) / np.float32(num - 1)
    i = np.arange(num - 1, dtype=np.float32)
    out = np.float32(start) * (np.float32(1) - i * c) + i * (np.float32(stop)
                                                            * c)
    return np.concatenate([out, [np.float32(stop)]]).astype(np.float32)


def _fk(model: cm.CharModel, frames34: torch.Tensor):
    return cm.forward_kinematics(
        model, frames34[..., 0:3], rot.exp_map_to_quat(frames34[..., 3:6]),
        cm.dof_to_rot(model, frames34[..., 6:]))


def resample_fps(model: cm.CharModel, frames34, src_fps: float,
                 dst_fps: float) -> torch.Tensor:
    """Resample a (T, 34) motion to a new frame rate (slerp on rotations)."""
    frames34 = _on(model, frames34)
    t_src = frames34.shape[0]
    duration = (t_src - 1) / src_fps
    t_dst = int(round(duration * dst_fps)) + 1
    fidx = torch.as_tensor(_linspace(0.0, duration, t_dst) * np.float32(
        src_fps), device=model.device)
    i0 = torch.clamp(torch.floor(fidx).long(), 0, t_src - 1)
    i1 = torch.clamp(i0 + 1, max=t_src - 1)
    blend = (fidx - i0)[:, None]

    pos = (1 - blend) * frames34[i0, 0:3] + blend * frames34[i1, 0:3]
    q0 = rot.exp_map_to_quat(frames34[i0, 3:6])
    q1 = rot.exp_map_to_quat(frames34[i1, 3:6])
    root_em = rot.quat_to_exp_map(rot.slerp(q0, q1, blend[:, 0]))
    jr0 = cm.dof_to_rot(model, frames34[i0, 6:])
    jr1 = cm.dof_to_rot(model, frames34[i1, 6:])
    dof = cm.rot_to_dof(model, rot.slerp(jr0, jr1, blend))
    return torch.cat([pos, root_em, dof], dim=-1)


def slice_motion(motion: md.MotionData, start: int, end: int) -> md.MotionData:
    return md.MotionData(
        frames=motion.frames[start:end].copy(), fps=motion.fps,
        loop_mode=motion.loop_mode,
        contacts=None if motion.contacts is None
        else motion.contacts[start:end].copy(),
        terrain=motion.terrain,
        hf_mask_inds=None if motion.hf_mask_inds is None
        else motion.hf_mask_inds[start:end])


def blend_motions(model: cm.CharModel, frames_a, frames_b,
                  blend_frames: int) -> torch.Tensor:
    """Stitch b after a with a slerp crossfade over ``blend_frames``."""
    frames_a, frames_b = _on(model, frames_a), _on(model, frames_b)
    a_tail = frames_a[-blend_frames:]
    b_head = frames_b[:blend_frames]
    w = torch.as_tensor(_linspace(0.0, 1.0, blend_frames),
                        device=model.device)[:, None]
    pos = (1 - w) * a_tail[:, 0:3] + w * b_head[:, 0:3]
    q = rot.slerp(rot.exp_map_to_quat(a_tail[:, 3:6]),
                  rot.exp_map_to_quat(b_head[:, 3:6]), w[:, 0])
    jr = rot.slerp(cm.dof_to_rot(model, a_tail[:, 6:]),
                   cm.dof_to_rot(model, b_head[:, 6:]), w)
    mid = torch.cat([pos, rot.quat_to_exp_map(q),
                     cm.rot_to_dof(model, jr)], dim=-1)
    return torch.cat(
        [frames_a[:-blend_frames], mid, frames_b[blend_frames:]], dim=0)


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


# ---------------------------------------------------------------------------
# Contacts & terrain from motion
# ---------------------------------------------------------------------------


def compute_contacts(model: cm.CharModel, terrain: terrain_lib.Terrain,
                     frames34, eps: float = 0.04) -> torch.Tensor:
    """Label per-body contact flags from geometry: a body is in contact when
    any of its contact points is within eps of the heightfield surface
    (nearest-cell lookup)."""
    body_pos, body_rot = _fk(model, _on(model, frames34))
    bidx = model.contact_point_body
    pts = (body_pos[..., bidx, :]
           + rot.quat_rotate(body_rot[..., bidx, :],
                             model.contact_point_offset.expand(
                                 body_pos[..., bidx, :].shape)))
    ground = terrain_lib.get_hf_val(terrain, pts[..., 0:2])
    near = (pts[..., 2] - model.contact_point_radius - ground) < eps
    per_body = torch.zeros(near.shape[:-1] + (model.num_bodies,),
                           device=near.device)
    per_body.index_add_(-1, bidx, near.float())
    return (per_body > 0).float()


def terrain_from_motion(model: cm.CharModel, frames34: np.ndarray,
                        dx: float = 0.4, padding: float = 1.0
                        ) -> md.HostTerrain:
    """Create a flat-floor terrain sized to a motion's footprint, with the
    floor at the motion's minimum body height (FK on ``model``'s device)."""
    body_pos, _ = _fk(model, _on(model, frames34))
    pts = body_pos.reshape(-1, 3).cpu().numpy()
    lo = pts[:, 0:2].min(0) - padding
    hi = pts[:, 0:2].max(0) + padding
    dims = np.maximum(np.ceil((hi - lo) / dx).astype(int) + 1, 4)
    floor = float(pts[:, 2].min()) - 0.05
    return md.HostTerrain(
        hf=np.full((dims[0], dims[1]), floor, np.float32),
        min_point=lo.astype(np.float32),
        dxdy=np.asarray([dx, dx], np.float32))


# ---------------------------------------------------------------------------
# Spatial / temporal editing ops
# (reference parity: zmotion_editing_tools/motion_edit_lib.py:291-497
#  stride/cut/stitch, :434-499 translate/rotate/heading,
#  :749-787 foot-penetration correction, :1165-1240 spatial variation)
# ---------------------------------------------------------------------------


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def stride_motion(frames34: np.ndarray, start: int, end: int,
                  stride: int) -> np.ndarray:
    """Keep every ``stride``-th frame inside [start, end) and resume at
    ``end + 1`` — frame ``end`` itself is always dropped, matching the
    reference exactly (motion_edit_lib.py:291-299 concatenates
    [:start] + [start:end:stride] + [end+1:])."""
    frames34 = np.asarray(frames34)
    return np.concatenate([frames34[:start], frames34[start:end:stride],
                           frames34[end + 1:]], axis=0)


def cut_motion(frames34: np.ndarray, start: int, end: int) -> np.ndarray:
    """Remove frames [start, end] entirely."""
    frames34 = np.asarray(frames34)
    return np.concatenate([frames34[:start], frames34[end + 1:]], axis=0)


def stitch_motions(frames_a: np.ndarray, frames_b: np.ndarray
                   ) -> np.ndarray:
    """Concatenate two (already sliced) motions back to back."""
    return np.concatenate([np.asarray(frames_a), np.asarray(frames_b)],
                          axis=0)


def translate_motion(frames34: np.ndarray, translation) -> np.ndarray:
    frames34 = np.array(frames34, copy=True)
    frames34[:, 0:3] += np.asarray(translation)
    return frames34


def rotate_motion(frames34: np.ndarray, quat, origin) -> np.ndarray:
    """Rigidly rotate a whole motion by ``quat`` about world point
    ``origin`` (root positions orbit, root orientations compose)."""
    frames34 = np.asarray(frames34)
    q = _f32(quat).expand(frames34.shape[0], 4)
    origin = _f32(origin)
    new_pos = rot.quat_rotate(q, _f32(frames34[:, 0:3]) - origin) + origin
    root_q = rot.exp_map_to_quat(_f32(frames34[:, 3:6]))
    new_em = rot.quat_to_exp_map(rot.quat_mul(q, root_q))
    out = np.array(frames34, copy=True)
    out[:, 0:3] = new_pos.numpy()
    out[:, 3:6] = new_em.numpy()
    return out


def change_heading_at_frame(frames34: np.ndarray, new_heading: float,
                            idx: int) -> np.ndarray:
    """Re-heading: rotate the whole motion about frame ``idx``'s root xy so
    that frame's heading becomes ``new_heading``."""
    frames34 = np.asarray(frames34)
    q_idx = rot.exp_map_to_quat(_f32(frames34[idx, 3:6]))
    dq = rot.quat_mul(rot.heading_to_quat(_f32(new_heading)),
                      rot.calc_heading_quat_inv(q_idx))
    return rotate_motion(frames34, dq.numpy(), frames34[idx, 0:3])


def move_xy_root_to_origin(frames34: np.ndarray) -> np.ndarray:
    """Translate so the first frame's root xy is at the origin (z kept)."""
    t = -np.asarray(frames34)[0, 0:3].copy()
    t[2] = 0.0
    return translate_motion(frames34, t)


def scale_motion_segment(frames34: np.ndarray, scale: float, start: int,
                         end: int) -> np.ndarray:
    """Scale the xy displacement of frames [start, end] about frame
    ``start``; later frames shift to stay continuous."""
    out = np.array(frames34, copy=True)
    disp = out[end, 0:2] - out[start, 0:2]
    new_disp = scale * disp
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.nan_to_num(new_disp / disp, nan=1.0, posinf=1.0,
                              neginf=1.0)
    canon = out[start, 0:2].copy()
    out[start:end + 1, 0:2] = (out[start:end + 1, 0:2] - canon) * ratio + canon
    out[end + 1:, 0:2] += new_disp - disp
    return out


def _contact_chain_midpoints(contacts_1d: np.ndarray) -> np.ndarray:
    """Midpoint frame index of every maximal run of contact==1."""
    c = np.asarray(contacts_1d) > 0
    if not c.any():
        return np.zeros((0,), np.int64)
    d = np.diff(c.astype(np.int8))
    starts = np.nonzero(d == 1)[0] + 1
    ends = np.nonzero(d == -1)[0]
    if c[0]:
        starts = np.concatenate([[0], starts])
    if c[-1]:
        ends = np.concatenate([ends, [len(c) - 1]])
    return (starts + ends) // 2


def foot_plant_frames(model: cm.CharModel, contacts: np.ndarray
                      ) -> np.ndarray:
    """Sorted unique midpoints of both feet's contact runs."""
    contacts = np.asarray(contacts)
    ids = [i for i, n in enumerate(model.body_names) if n.endswith("foot")]
    mids = np.concatenate([_contact_chain_midpoints(contacts[:, i])
                           for i in ids]) if ids else np.zeros(0, np.int64)
    return np.unique(mids)


def spatially_vary_motion(model: cm.CharModel, frames34: np.ndarray,
                          contacts: np.ndarray, rng: np.random.Generator,
                          min_scale: float = 0.8, max_scale: float = 1.3,
                          max_angle_deg: float = 30.0) -> np.ndarray:
    """Augmentation: random xy stretch/squish + heading perturbation of
    each between-footplant segment (terrain-aware pipelines re-derive the
    terrain from the varied motion afterwards). The same ``rng`` calls in
    the same order as the JAX package."""
    out = np.array(frames34, copy=True)
    plants = foot_plant_frames(model, contacts)
    for i in range(len(plants) - 1):
        s, e = int(plants[i]), int(plants[i + 1])
        if e - s <= 1:
            continue
        out = scale_motion_segment(out, rng.uniform(min_scale, max_scale),
                                   s, e)
        ang = rng.uniform(-max_angle_deg, max_angle_deg) * np.pi / 180.0
        q = rot.heading_to_quat(_f32(ang)).numpy()
        out[s:] = rotate_motion(out[s:], q, out[s, 0:3].copy())
    return out


def correct_foot_ground_pen(model: cm.CharModel, frames34: np.ndarray,
                            ground_height: float = 0.0) -> np.ndarray:
    """Lift each frame's root so no foot contact sample penetrates the
    ground plane (per-frame z shift; frames already above are untouched).

    Uses the model's contact sample spheres (offset + radius), the same
    geometry the physics contact model sees."""
    frames = _on(model, frames34)
    body_pos, body_rot = _fk(model, frames)
    foot_ids = [i for i, n in enumerate(model.body_names)
                if n.endswith("foot")]
    bidx = model.contact_point_body
    sel = torch.isin(bidx, torch.as_tensor(foot_ids, device=bidx.device))
    bsel = bidx[sel]
    offs = model.contact_point_offset[sel]
    rads = model.contact_point_radius[sel]
    pts = (body_pos[:, bsel]
           + rot.quat_rotate(body_rot[:, bsel],
                             offs.expand((frames.shape[0],) + offs.shape)))
    min_z = torch.amin(pts[..., 2] - rads, dim=-1)
    lift = torch.clamp(ground_height - min_z, min=0.0)
    out = frames.cpu().numpy().copy()
    out[:, 2] += lift.cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# Motion-matching transition search
# (reference parity: zmotion_editing_tools/motion_edit_lib.py:1025-1128,
#  the search behind MOTION_FORGE's interactive stitcher
#  polyscope_stitcher.py — find the best frame pair to transition from
#  clip A into clip B, plus the rigid alignment of B onto A there)
# ---------------------------------------------------------------------------


def _match_features(model: cm.CharModel, frames34, fps: float):
    """Canonicalized per-frame matching features (reference
    motion_edit_lib.py:1046-1077): heading-local body positions with the
    root body's xy subtracted, heading-local root velocity, and world-frame
    root angular velocity (the reference leaves ang-vel uncanonicalized).
    Velocities are the same forward differences build_motion_lib stores."""
    frames34 = _on(model, frames34)
    root_pos = frames34[:, 0:3]
    root_rot = rot.exp_map_to_quat(frames34[:, 3:6])
    body_pos, _ = cm.forward_kinematics(model, root_pos, root_rot,
                                        cm.dof_to_rot(model, frames34[:, 6:]))
    heading_inv = rot.calc_heading_quat_inv(root_rot)
    bp = body_pos - F.pad(body_pos[:, 0:1, 0:2], (0, 1))
    bp = rot.quat_rotate(heading_inv[:, None, :].expand(bp.shape[:-1] + (4,)),
                         bp)
    root_vel = fps * (root_pos[1:] - root_pos[:-1])
    root_vel = torch.cat([root_vel, root_vel[-1:]], 0)
    root_vel = rot.quat_rotate(heading_inv, root_vel)
    drot = rot.quat_diff(root_rot[:-1], root_rot[1:])
    ang_vel = fps * rot.quat_to_exp_map(drot)
    ang_vel = torch.cat([ang_vel, ang_vel[-1:]], 0)
    return bp, root_vel, ang_vel


def search_for_matching_motion_frames(
        model: cm.CharModel, frames_a: np.ndarray, frames_b: np.ndarray,
        fps: float, range_a: Optional[Tuple[int, int]] = None,
        range_b: Optional[Tuple[int, int]] = None,
        w_body: float = 0.65, w_vel: float = 0.2, w_ang: float = 0.15):
    """Best transition frame pair between two clips.

    Scores every (i, j) pair inside the search windows with the reference's
    motion-matching error (motion_edit_lib.py:1080-1095: 0.65 * summed
    non-root body-position distance + 0.2 * root-vel distance + 0.15 *
    root-ang-vel distance, all on canonicalized features) as one [Fa, Fb]
    matrix on the model's device. Like the reference (:1083), the last
    frame of A's window is excluded; of tied minima the first (row-major)
    wins, as ``jnp.argmin`` picks it.

    Returns ``(idx_a, idx_b, heading_diff, root_pos_diff, err)``: frame
    indices into the *full* clips, plus the rigid alignment of B onto A at
    the match — rotate B by ``heading_diff`` about the world origin, then
    translate by ``root_pos_diff`` (z component zero), exactly the
    transform the reference returns (:1104-1128).
    """
    frames_a = np.asarray(frames_a)
    frames_b = np.asarray(frames_b)
    a0, a1 = range_a if range_a is not None else (0, frames_a.shape[0] - 1)
    b0, b1 = range_b if range_b is not None else (0, frames_b.shape[0] - 1)
    a1 = min(a1, frames_a.shape[0] - 1)
    b1 = min(b1, frames_b.shape[0] - 1)
    # the reference asserts start < end (:1083); with A's last window frame
    # excluded an empty window would argmin over a zero-size matrix
    if a1 <= a0 or b1 < b0:
        raise ValueError(
            f"empty match window: range_a=({a0}, {a1}) needs a1 > a0 "
            f"(last frame excluded), range_b=({b0}, {b1}) needs b1 >= b0")

    bp_a, rv_a, av_a = _match_features(model, frames_a, fps)
    bp_b, rv_b, av_b = _match_features(model, frames_b, fps)
    bp_a, rv_a, av_a = bp_a[a0:a1], rv_a[a0:a1], av_a[a0:a1]  # excl. last
    bp_b, rv_b, av_b = bp_b[b0:b1 + 1], rv_b[b0:b1 + 1], av_b[b0:b1 + 1]

    body = torch.linalg.norm(bp_a[:, None, 1:] - bp_b[None, :, 1:], dim=-1)
    err = (w_body * torch.sum(body, dim=-1)
           + w_vel * torch.linalg.norm(rv_a[:, None] - rv_b[None, :], dim=-1)
           + w_ang * torch.linalg.norm(av_a[:, None] - av_b[None, :],
                                       dim=-1))
    flat = int(torch.argmin(err))
    i, j = divmod(flat, err.shape[1])
    idx_a, idx_b = a0 + i, b0 + j

    rot_a = rot.exp_map_to_quat(_f32(frames_a[idx_a, 3:6]))
    rot_b = rot.exp_map_to_quat(_f32(frames_b[idx_b, 3:6]))
    heading_diff = float(rot.calc_heading(rot_a) - rot.calc_heading(rot_b))
    q = rot.heading_to_quat(_f32(heading_diff))
    pos_b = rot.quat_rotate(q, _f32(frames_b[idx_b, 0:3]))
    root_pos_diff = (_f32(frames_a[idx_a, 0:3]) - pos_b).numpy()
    root_pos_diff[2] = 0.0
    return idx_a, idx_b, heading_diff, root_pos_diff, float(err[i, j])


def align_matched_motion(frames_b: np.ndarray, heading_diff: float,
                         root_pos_diff) -> np.ndarray:
    """Apply the rigid transform from search_for_matching_motion_frames:
    rotate about the world origin, then translate (reference applies the
    same pair in the stitcher before concatenating)."""
    q = rot.heading_to_quat(_f32(heading_diff)).numpy()
    return translate_motion(
        rotate_motion(frames_b, q, np.zeros(3)), root_pos_diff)


def stitch_at_match(model: cm.CharModel, frames_a: np.ndarray,
                    frames_b: np.ndarray, fps: float,
                    range_a: Optional[Tuple[int, int]] = None,
                    range_b: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Search + align + concatenate: A up to its match frame, then B from
    just after its match frame, rigidly aligned onto A (the stitcher's
    one-click flow)."""
    idx_a, idx_b, hd, dp, _ = search_for_matching_motion_frames(
        model, frames_a, frames_b, fps, range_a, range_b)
    aligned = align_matched_motion(frames_b, hd, dp)
    return stitch_motions(np.asarray(frames_a)[:idx_a + 1],
                          aligned[idx_b + 1:])
