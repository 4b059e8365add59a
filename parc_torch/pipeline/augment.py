"""Batch terrain-aware motion augmentation.

Expands an initial dataset with spatial variations: each new clip is a
length-weighted sample of a source motion, randomly rotated about the
origin and stretched along x/y, placed on an augmented copy of its
terrain (global height rescale or random boxes stamped along the
motion's path), then reconciled with the terrain by the contact optimization
(on the character model's device).

Reference parity: tools/motion_opt/augment_motions.py:1-241 with the
config surface of tools/motion_opt/config/*_aug.yaml (HEIGHT_SCALE /
BOXES_ALONG_PATH / NONE augmentation types). The numpy draws are the JAX
package's, in its order, so a seed gives the same variations in both.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from parc_torch.anim import char_model as cm
from parc_torch.anim import motion_data as md
from parc_torch.opt import motion_opt
from parc_torch.utils import rotation as rot
from parc_torch.utils import terrain as terrain_lib


@dataclasses.dataclass
class AugmentConfig:
    num_new_motions: int = 16
    max_motion_len: float = 10.0          # seconds; longer clips are sliced
    # random heading rotation (degrees) and per-axis stretch ranges
    min_heading_angle: float = -15.0
    max_heading_angle: float = 15.0
    x_scale: Tuple[float, float] = (0.95, 1.05)
    y_scale: Tuple[float, float] = (0.95, 1.05)
    sample_weight_by_length: bool = True
    # terrain augmentation (reference TerrainAugmentationType)
    # height_scale | boxes_along_path | none
    terrain_aug: str = "height_scale"
    min_h_scale: float = 0.8
    max_h_scale: float = 1.05
    bad_h_range: Tuple[float, float] = (0.98, 1.02)   # avoid no-op scales
    min_num_boxes: int = 2
    max_num_boxes: int = 6
    box_min_h: float = -0.3
    box_max_h: float = 0.3
    box_min_len: float = 4.0
    box_max_len: float = 8.0
    terrain_padding: int = 0
    slice_terrain: bool = False
    # augmentation re-optimizes against a *new* terrain: the original
    # contact-run constraints no longer apply (reference:
    # augment_motions.py:225-226 passes w_body_constraints=0)
    opt_cfg: motion_opt.MotionOptConfig = dataclasses.field(
        default_factory=lambda: motion_opt.MotionOptConfig(
            iters=1000, auto_body_constraints=False))


def _transform_frames(cfg: AugmentConfig, rng: np.random.Generator,
                      frames: np.ndarray) -> np.ndarray:
    """Random heading rotation about the origin + per-axis xy stretch
    (reference: augment_motions.py:164-175)."""
    frames = frames.copy()
    ang = np.deg2rad(rng.uniform(cfg.min_heading_angle,
                                 cfg.max_heading_angle))
    ca, sa = np.cos(ang), np.sin(ang)
    x, y = frames[:, 0].copy(), frames[:, 1].copy()
    frames[:, 0] = ca * x - sa * y
    frames[:, 1] = sa * x + ca * y
    frames[:, 3:6] = rot.rotate_exp_map_by_heading(
        torch.tensor(ang, dtype=torch.float32),
        torch.as_tensor(frames[:, 3:6])).numpy()
    frames[:, 0] *= rng.uniform(*cfg.x_scale)
    frames[:, 1] *= rng.uniform(*cfg.y_scale)
    return frames


def _augment_terrain(cfg: AugmentConfig, rng: np.random.Generator,
                     terrain: md.HostTerrain,
                     frames: np.ndarray) -> md.HostTerrain:
    hf = terrain.hf.copy()
    if cfg.terrain_aug == "height_scale":
        scale = rng.uniform(cfg.min_h_scale, cfg.max_h_scale)
        while cfg.bad_h_range[0] < scale < cfg.bad_h_range[1]:
            scale = rng.uniform(cfg.min_h_scale, cfg.max_h_scale)
        hf = (hf * scale).astype(np.float32)
    elif cfg.terrain_aug == "boxes_along_path":
        n = int(rng.integers(cfg.min_num_boxes, cfg.max_num_boxes + 1))
        idx = rng.integers(0, frames.shape[0], size=n)
        centers = ((frames[idx, 0:2] - terrain.min_point[:2])
                   / terrain.dxdy[:2])
        hf = terrain_lib.add_boxes_at_points(
            rng, hf, centers, min_h=cfg.box_min_h, max_h=cfg.box_max_h,
            min_len=cfg.box_min_len, max_len=cfg.box_max_len)
    elif cfg.terrain_aug != "none":
        raise ValueError(cfg.terrain_aug)
    return dataclasses.replace(terrain, hf=hf.astype(np.float32),
                               hf_mask=None, hf_maxmin=None)


def augment_motion(model: cm.CharModel, cfg: AugmentConfig,
                   motion: md.MotionData,
                   rng: np.random.Generator) -> md.MotionData:
    """One augmented variation of ``motion`` (terrain + frames + opt)."""
    frames = motion.frames.astype(np.float32)
    contacts = (motion.contacts.astype(np.float32)
                if motion.contacts is not None
                else np.zeros((frames.shape[0], model.num_bodies),
                              np.float32))
    max_frames = int(round(motion.fps * cfg.max_motion_len))
    if frames.shape[0] > max_frames:
        start = int(rng.integers(0, frames.shape[0] - max_frames))
        frames = frames[start:start + max_frames]
        contacts = contacts[start:start + max_frames]

    frames = _transform_frames(cfg, rng, frames)

    terrain = motion.terrain
    if terrain is None:
        ground = float(frames[:, 2].min()) - 0.9
        dim = 24
        terrain = md.HostTerrain(
            hf=np.full((dim, dim), ground, np.float32),
            min_point=np.asarray(frames[:, 0:2].min(0) - 4.0, np.float32),
            dxdy=np.asarray([0.4, 0.4], np.float32))
    dev = terrain.to_device(model.device)
    if cfg.terrain_padding > 0:
        dev = terrain_lib.pad_terrain(dev, cfg.terrain_padding)
    if cfg.slice_terrain:
        dev = terrain_lib.slice_terrain_around_points(
            dev, frames[:, 0:2], padding=2 * float(terrain.dxdy[0]),
            localize=False)
    terrain = md.HostTerrain(hf=dev.hf.cpu().numpy(),
                             min_point=dev.min_point.cpu().numpy(),
                             dxdy=dev.dxdy.cpu().numpy())
    terrain = _augment_terrain(cfg, rng, terrain, frames)

    opt_frames, _ = motion_opt.motion_contact_optimization(
        model, terrain.to_device(model.device), frames, contacts,
        cfg.opt_cfg)
    return md.MotionData(frames=opt_frames.cpu().numpy().astype(np.float32),
                         fps=motion.fps, loop_mode=md.CLAMP,
                         contacts=contacts, terrain=terrain)


def run_augment(model: cm.CharModel, motions: List[md.MotionData],
                out_dir: str, cfg: AugmentConfig = AugmentConfig(),
                names: Optional[List[str]] = None,
                seed: int = 0) -> List[str]:
    """Generate cfg.num_new_motions augmented clips into out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    lengths = np.asarray([m.length for m in motions], np.float64)
    w = lengths if cfg.sample_weight_by_length else np.ones_like(lengths)
    w = w / w.sum()
    counts = [0] * len(motions)
    paths = []
    for _ in range(cfg.num_new_motions):
        i = int(rng.choice(len(motions), p=w))
        counts[i] += 1
        clip = augment_motion(model, cfg, motions[i], rng)
        base = (names[i] if names else f"motion{i:04d}")
        base = os.path.splitext(os.path.basename(base))[0]
        path = os.path.join(out_dir, f"{base}_aug{counts[i]:03d}.npz")
        md.save_motion_data(path, clip)
        paths.append(path)
    return paths
