"""MDM training-window sampler.

Samples 15-frame motion windows + 2 previous-state conditioning frames,
canonicalizes them to the heading frame of the last previous frame,
extracts the 31x31 local heightfield, applies motion-aware heightfield
augmentation (only where the motion's hf_maxmin allows), and samples a
future xy-direction target.

Every random function is split into its draws (``draw_*``, from an explicit
``torch.Generator``) and a deterministic body that takes them, so a test can
feed both stacks the same random numbers.

Reference parity: diffusion/mdm_heightfield_contact_motion_sampler.py:30-574.

Frame features (91-D):
  [ root_pos(3) | root_rot exp-map(3) | joint body pos(14*3) |
    joint dof(28) | contacts(15) ]
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from reference.anim import char_model as cm
from reference.anim import motion_lib as ml
from reference.utils import rotation as rot
from reference.utils import terrain as terrain_lib

POOL_PASSES = 3
POOL_SIZES = (2, 4, 8)


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    seq_len: int = 15
    num_prev_states: int = 2
    fps: float = 30.0
    # local heightfield (reference: train_gen_default.yaml heightmap:)
    hf_num_x_neg: int = 10
    hf_num_x_pos: int = 20
    hf_num_y: int = 15
    hf_dx: float = 0.2
    max_h: float = 3.0
    # future target (XY_DIR)
    future_window_min: float = 0.4
    future_window_max: float = 1.5
    target_dir_len_eps: float = 0.1
    future_pos_noise_scale: float = 0.05
    # augmentation
    use_hf_augmentation: bool = True
    hf_maxpool_chance: float = 0.15
    hf_max_maxpool_size: int = 10
    max_num_boxes: int = 4
    box_min_len: int = 2
    box_max_len: int = 12
    hf_change_height_chance: float = 0.1
    # conditioning noise
    angle_noise_scale: float = 0.01
    pos_noise_scale: float = 0.01

    @property
    def hf_dim_x(self) -> int:
        return self.hf_num_x_neg + self.hf_num_x_pos + 1

    @property
    def hf_dim_y(self) -> int:
        return 2 * self.hf_num_y + 1

    @property
    def total_frames(self) -> int:
        return self.seq_len + self.num_prev_states

    def frame_dim(self, model: cm.CharModel) -> int:
        nb = model.num_bodies
        return 3 + 3 + 3 * (nb - 1) + model.dof_size + nb


@dataclasses.dataclass
class WindowBatch:
    """One sampled training batch."""

    frames: torch.Tensor        # (B, seq_len, frame_dim) canonical, to denoise
    prev_states: torch.Tensor   # (B, num_prev, frame_dim)
    hf: torch.Tensor            # (B, 31, 31) canonical local heightfield
    target_dir: torch.Tensor    # (B, 2)
    # canonical-frame metadata for losses
    canon_heading: torch.Tensor  # (B,)
    canon_xy: torch.Tensor       # (B, 2)
    canon_z: torch.Tensor        # (B,)
    motion_ids: torch.Tensor     # (B,)

    def replace(self, **changes) -> "WindowBatch":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class BoxDraws:
    """Random boxes, one set per box slot: (N, B, ...)."""

    ij: torch.Tensor      # (N, B, 2) int64 corner cell
    wl: torch.Tensor      # (N, B, 2) int64 extent in cells
    height: torch.Tensor  # (N, B)
    active: torch.Tensor  # (N, B) bool


@dataclasses.dataclass
class AugmentDraws:
    """The draws of :func:`_augment_hf`."""

    pool_do: torch.Tensor    # (POOL_PASSES, B) bool
    pool_size: torch.Tensor  # (POOL_PASSES, B) int64
    pool_kind: torch.Tensor  # (POOL_PASSES, B) int64: square / x / y
    boxes: BoxDraws
    shift_do: torch.Tensor   # (B,) bool
    shift_dh: torch.Tensor   # (B,)


@dataclasses.dataclass
class BatchDraws:
    """The draws of :func:`sample_batch`."""

    motion_ids: torch.Tensor       # (B,) int64
    start_unit: torch.Tensor       # (B,) U[0, 1): the window start's fraction
    fut_dt: torch.Tensor           # (B,) s past the window's end
    fut_noise: torch.Tensor        # (B, 2) standard normal
    augment: Optional[AugmentDraws]  # None: no augmentation


def _uniform(generator, shape, device, lo=0.0, hi=1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return u * (hi - lo) + lo if (lo, hi) != (0.0, 1.0) else u


def _features(model: cm.CharModel, frame: ml.MotionFrame,
              canon_xy, canon_z, canon_heading_inv) -> torch.Tensor:
    """Canonicalized 91-D features for a batch of frames (..., T)."""
    root_pos = frame.root_pos - torch.cat(
        [canon_xy, canon_z[..., None]], -1)[..., None, :]
    xy = rot.rotate_2d_vec(root_pos[..., 0:2], canon_heading_inv[..., None])
    root_pos = torch.cat([xy, root_pos[..., 2:]], dim=-1)
    root_rot = rot.quat_mul(
        rot.heading_to_quat(canon_heading_inv)[..., None, :], frame.root_rot)
    body_pos, _ = cm.forward_kinematics(model, root_pos, root_rot,
                                        frame.joint_rot)
    joint_pos = body_pos[..., 1:, :] - root_pos[..., None, :]
    dof = cm.rot_to_dof(model, frame.joint_rot)
    return torch.cat([
        root_pos,
        rot.quat_to_exp_map(root_rot),
        joint_pos.reshape(joint_pos.shape[:-2] + (-1,)),
        dof,
        frame.contacts,
    ], dim=-1)


def split_features(model: cm.CharModel, x: torch.Tensor) -> dict:
    """Inverse index map of the 91-D feature vector."""
    nb = model.num_bodies
    i0 = 3
    i1 = i0 + 3
    i2 = i1 + 3 * (nb - 1)
    i3 = i2 + model.dof_size
    return dict(root_pos=x[..., 0:i0], root_rot=x[..., i0:i1],
                joint_pos=x[..., i1:i2], dof=x[..., i2:i3],
                contacts=x[..., i3:])


def _local_hf_points(cfg: SamplerConfig, canon_xy, canon_heading):
    """World xy of the canonical local grid (B, X, Y, 2)."""
    dev = canon_xy.device
    xs = (torch.arange(cfg.hf_dim_x, device=dev) - cfg.hf_num_x_neg) \
        * cfg.hf_dx
    ys = (torch.arange(cfg.hf_dim_y, device=dev) - cfg.hf_num_y) * cfg.hf_dx
    gx, gy = torch.meshgrid(xs.float(), ys.float(), indexing="ij")
    c = torch.cos(canon_heading)[..., None, None]
    s = torch.sin(canon_heading)[..., None, None]
    wx = c * gx - s * gy
    wy = s * gx + c * gy
    return torch.stack([wx, wy], -1) + canon_xy[..., None, None, :]


def _gather_terrain(lib: ml.MotionLib, motion_ids, pts_xy):
    """Nearest-cell gathers of hf and hf_maxmin at world points (rounding
    half to even, as jnp.round does)."""
    mp = lib.terrain_min_point[motion_ids][..., None, None, :]
    inds = torch.round((pts_xy - mp) / lib.terrain_dxdy).long()
    dims = torch.as_tensor(lib.terrain_hf.shape[-2:], device=inds.device)
    inds = torch.minimum(torch.clamp(inds, min=0), dims - 1)
    t = motion_ids[..., None, None]
    hf = lib.terrain_hf[t, inds[..., 0], inds[..., 1]]
    mm = lib.terrain_maxmin[t, inds[..., 0], inds[..., 1]]
    return hf, mm


def draw_boxes(cfg: SamplerConfig, generator, b: int, height_range,
               active_chance: float, device) -> BoxDraws:
    """cfg.max_num_boxes random boxes per row of a (b, X, Y) heightfield."""
    n = cfg.max_num_boxes

    def randint(lo, hi):
        return torch.randint(lo, hi, (n, b), generator=generator,
                             device=device)

    ij = torch.stack([randint(0, cfg.hf_dim_x), randint(0, cfg.hf_dim_y)], -1)
    wl = torch.stack([randint(cfg.box_min_len, cfg.box_max_len + 1)
                      for _ in range(2)], -1)
    height = _uniform(generator, (n, b), device, *height_range)
    active = _uniform(generator, (n, b), device) < active_chance
    return BoxDraws(ij=ij, wl=wl, height=height, active=active)


def draw_augment(cfg: SamplerConfig, generator, b: int,
                 device) -> AugmentDraws:
    shape = (POOL_PASSES, b)
    return AugmentDraws(
        pool_do=_uniform(generator, shape, device) < cfg.hf_maxpool_chance,
        pool_size=torch.randint(2, cfg.hf_max_maxpool_size + 1, shape,
                                generator=generator, device=device),
        pool_kind=torch.randint(0, 3, shape, generator=generator,
                                device=device),
        boxes=draw_boxes(cfg, generator, b, (-1.0, 1.5), 0.5, device),
        shift_do=_uniform(generator, (b,), device)
        < cfg.hf_change_height_chance,
        shift_dh=_uniform(generator, (b,), device, -0.6, 0.6))


def _box_mask(hf: torch.Tensor, ij, wl) -> torch.Tensor:
    """(B, X, Y) cells inside each row's box."""
    x_ids = torch.arange(hf.shape[1], device=hf.device)[None, :, None]
    y_ids = torch.arange(hf.shape[2], device=hf.device)[None, None, :]
    return ((x_ids >= ij[:, 0, None, None])
            & (x_ids < (ij[:, 0] + wl[:, 0])[:, None, None])
            & (y_ids >= ij[:, 1, None, None])
            & (y_ids < (ij[:, 1] + wl[:, 1])[:, None, None]))


def _augment_hf(cfg: SamplerConfig, hf, hf_max, hf_min,
                d: AugmentDraws) -> torch.Tensor:
    """Motion-aware augmentation: maxpool passes + random boxes + height
    shifts, all clamped to [hf_min, hf_max] so cells the motion touched
    stay put (reference: sampler :365-407, terrain_util:2017-2047)."""
    # up to 3 maxpool passes, each square / x-only / y-only with a window
    # of the largest of 2, 4, 8 not above the drawn size
    for i in range(POOL_PASSES):
        pooled = hf
        for s in POOL_SIZES:
            for kind, (sx, sy) in enumerate(((s, s), (s, 1), (1, s))):
                sel = d.pool_do[i] & (d.pool_size[i] >= s) \
                    & (d.pool_kind[i] == kind)
                pooled = torch.where(sel[:, None, None],
                                     terrain_lib.pool_same(hf, sx, sy), pooled)
        hf = terrain_lib.clip(pooled, hf_min, hf_max)

    boxes = d.boxes
    for k in range(boxes.ij.shape[0]):
        inside = _box_mask(hf, boxes.ij[k], boxes.wl[k])
        new = terrain_lib.clip(boxes.height[k][:, None, None], hf_min,
                               hf_max)
        hf = torch.where(inside & boxes.active[k][:, None, None], new, hf)

    # global height shift where free
    return torch.where(d.shift_do[:, None, None],
                       terrain_lib.clip(hf + d.shift_dh[:, None, None],
                                        hf_min, hf_max),
                       hf)


def window_features(model: cm.CharModel, cfg: SamplerConfig,
                    lib: ml.MotionLib, motion_ids: torch.Tensor,
                    t0: torch.Tensor):
    """Deterministic canonicalized window features at given start times.

    Returns ((B, total_frames, frame_dim) features, (canon_xy, canon_z,
    canon_heading)). Shared by the stochastic training sampler and the
    exact whole-dataset statistics pass."""
    dt = 1.0 / cfg.fps
    offsets = torch.arange(cfg.total_frames, device=t0.device,
                           dtype=torch.float32) * dt
    times = t0[:, None] + offsets[None, :]
    ids = motion_ids[:, None].expand(times.shape)
    frame = ml.calc_motion_frame(lib, ids, times)

    # canonical frame: last prev state (index num_prev-1)
    ci = cfg.num_prev_states - 1
    canon_xy = frame.root_pos[:, ci, 0:2]
    canon_z = frame.root_pos[:, ci, 2]
    canon_heading = rot.calc_heading(frame.root_rot[:, ci])
    feats = _features(model, frame, canon_xy, canon_z, -canon_heading)
    return feats, (canon_xy, canon_z, canon_heading)


def draw_batch(cfg: SamplerConfig, lib: ml.MotionLib,
               generator: torch.Generator, batch_size: int,
               augment: bool = True) -> BatchDraws:
    dev = lib.device
    return BatchDraws(
        motion_ids=ml.sample_motions(lib, generator, batch_size),
        start_unit=_uniform(generator, (batch_size,), dev),
        fut_dt=_uniform(generator, (batch_size,), dev,
                        cfg.future_window_min, cfg.future_window_max),
        fut_noise=torch.randn((batch_size, 2), generator=generator,
                              device=dev),
        augment=(draw_augment(cfg, generator, batch_size, dev)
                 if augment and cfg.use_hf_augmentation else None))


def batch_from_draws(model: cm.CharModel, cfg: SamplerConfig,
                     lib: ml.MotionLib, d: BatchDraws) -> WindowBatch:
    """The canonicalized training batch that the draws ``d`` select."""
    dt = 1.0 / cfg.fps
    motion_ids = d.motion_ids
    # window start (time of first prev state); keep window inside the clip
    window_dur = (cfg.total_frames - 1) * dt
    max_start = torch.clamp(lib.lengths[motion_ids] - window_dur, min=0.0)
    t0 = d.start_unit * max_start

    feats, (canon_xy, canon_z, canon_heading) = window_features(
        model, cfg, lib, motion_ids, t0)
    prev_states = feats[:, :cfg.num_prev_states]
    frames = feats[:, cfg.num_prev_states:]

    # local heightfield, relative to canonical root z
    pts = _local_hf_points(cfg, canon_xy, canon_heading)
    hf, mm = _gather_terrain(lib, motion_ids, pts)
    if d.augment is not None:
        hf = _augment_hf(cfg, hf, mm[..., 0], mm[..., 1], d.augment)
    hf = torch.clamp(hf - canon_z[:, None, None], -cfg.max_h, cfg.max_h)

    # future xy-direction target
    fut_time = t0 + window_dur + d.fut_dt
    fut = ml.calc_motion_frame(lib, motion_ids, fut_time)
    fut_xy = fut.root_pos[..., 0:2] + cfg.future_pos_noise_scale * d.fut_noise
    delta = rot.rotate_2d_vec(fut_xy - canon_xy, -canon_heading)
    norm = torch.linalg.norm(delta, dim=-1, keepdim=True)
    target_dir = torch.where(norm > cfg.target_dir_len_eps,
                             delta / torch.clamp(norm, min=1e-6),
                             torch.zeros_like(delta))
    return WindowBatch(frames=frames, prev_states=prev_states, hf=hf,
                       target_dir=target_dir, canon_heading=canon_heading,
                       canon_xy=canon_xy, canon_z=canon_z,
                       motion_ids=motion_ids)


def sample_batch(model: cm.CharModel, cfg: SamplerConfig, lib: ml.MotionLib,
                 generator: torch.Generator, batch_size: int,
                 augment: bool = True) -> WindowBatch:
    """Sample a canonicalized training batch."""
    return batch_from_draws(model, cfg, lib, draw_batch(
        cfg, lib, generator, batch_size, augment))


def compute_feature_stats(model: cm.CharModel, cfg: SamplerConfig,
                          lib: ml.MotionLib, generator: torch.Generator,
                          num_samples: int = 4096):
    """Per-frame-slot mean/std over sampled windows — fast Monte-Carlo
    variant for tests/tiny runs; training uses the exact pass below."""
    batch = sample_batch(model, cfg, lib, generator, num_samples,
                         augment=False)
    x = torch.cat([batch.prev_states, batch.frames], dim=1)
    mean = torch.mean(x, dim=0)
    std = torch.clamp(torch.std(x, dim=0, correction=0), min=1e-3)
    return mean, std  # (total_frames, frame_dim)


def compute_feature_stats_exact(model: cm.CharModel, cfg: SamplerConfig,
                                lib: ml.MotionLib, chunk: int = 8192):
    """EXACT per-frame-slot mean/std over every window of every motion
    (reference: diffusion/mdm.py:480-548): deterministic, no run-to-run
    standardization jitter.

    Windows start on the uniform dt = 1/cfg.fps grid; each motion with
    length L contributes floor((L - window_dur)/dt) + 1 windows (min 1).
    Two passes over chunks of at most ``chunk`` windows: the mean, then the
    variance about it (centred moments avoid f32 cancellation). The last
    chunk is simply shorter: eager PyTorch has no static shape to pad to,
    so the JAX package's zero-weight padding rows are not needed.
    """
    dev = lib.device
    dt = 1.0 / cfg.fps
    window_dur = (cfg.total_frames - 1) * dt
    lengths = lib.lengths.cpu().numpy()
    counts = np.maximum(
        np.floor((lengths - window_dur) / dt + 1e-6).astype(np.int64) + 1, 1)
    motion_ids = torch.as_tensor(np.repeat(np.arange(len(counts)), counts),
                                 device=dev)
    t0 = torch.as_tensor(
        (np.concatenate([np.arange(c) for c in counts]) * dt
         ).astype(np.float32), device=dev)
    total_w = len(motion_ids)

    def moments(shift, power):
        acc = 0.0
        for i in range(0, total_w, chunk):
            feats, _ = window_features(model, cfg, lib,
                                       motion_ids[i:i + chunk],
                                       t0[i:i + chunk])
            acc = acc + torch.sum((feats - shift) ** power, dim=0)
        return acc

    zero = torch.zeros((cfg.total_frames, cfg.frame_dim(model)), device=dev)
    mean = moments(zero, 1) / total_w
    std = torch.clamp(torch.sqrt(moments(mean, 2) / total_w), min=1e-3)
    return mean, std  # (total_frames, frame_dim)


def generate_ood_hfs(cfg: SamplerConfig, generator: torch.Generator,
                     batch: int, center_z: torch.Tensor,
                     boxes: Optional[BoxDraws] = None) -> torch.Tensor:
    """Synthetic out-of-distribution local heightfields: flat plane at the
    character's floor height plus random boxes, with the center 5x5 cells
    protected (reference: mdm_heightfield_contact_motion_sampler.py:490-524
    generate_hfs). ``boxes`` are the draws (from ``generator`` if None)."""
    if boxes is None:
        boxes = draw_boxes(cfg, generator, batch, (-cfg.max_h, cfg.max_h),
                           0.75, center_z.device)
    hf = center_z[:, None, None].expand(batch, cfg.hf_dim_x, cfg.hf_dim_y)
    x_ids = torch.arange(cfg.hf_dim_x, device=hf.device)[:, None]
    y_ids = torch.arange(cfg.hf_dim_y, device=hf.device)[None, :]
    protected = ((torch.abs(x_ids - cfg.hf_num_x_neg) <= 2)
                 & (torch.abs(y_ids - cfg.hf_num_y) <= 2))
    for k in range(boxes.ij.shape[0]):
        inside = _box_mask(hf, boxes.ij[k], boxes.wl[k]) & ~protected
        hf = torch.where(inside & boxes.active[k][:, None, None],
                         center_z[:, None, None]
                         + boxes.height[k][:, None, None], hf)
    return torch.clamp(hf, -cfg.max_h, cfg.max_h)
