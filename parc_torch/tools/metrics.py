"""Motion-quality metrics and dataset statistics.

Reference parity: tools/motion_tests/compute_losses.py (per-motion CSV of
final-node distance, motion length, mean jerk, frames-with-jerk-over-X,
contact loss, penetration loss, grouped by terrain class) and
tools/motion_tests/compute_stats.py (dataset-wide body velocity /
acceleration / jerk distributions — the source of the jerk/speed/acc
guidance thresholds in diffusion_util.MDMCustomGuidance:49-57).

Everything runs on the device of the ``CharModel`` passed in.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from parc_torch.anim import char_model as cm
from parc_torch.anim import motion_data as md
from parc_torch.utils import rotation as rot
from parc_torch.utils import terrain as terrain_lib


@dataclasses.dataclass
class MotionMetrics:
    """Per-motion quality metrics (all floats)."""

    motion_length: float
    mean_jerk: float
    max_jerk: float
    frames_with_jerk_over: float
    contact_loss: float
    pen_loss: float
    final_node_dist: Optional[float] = None

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def _body_positions(model: cm.CharModel, frames34: torch.Tensor):
    root_quat = rot.exp_map_to_quat(frames34[..., 3:6])
    joint_rot = cm.dof_to_rot(model, frames34[..., 6:])
    return cm.forward_kinematics(model, frames34[..., 0:3], root_quat,
                                 joint_rot)


def _frames(model: cm.CharModel, motion: md.MotionData) -> torch.Tensor:
    return torch.as_tensor(np.asarray(motion.frames, np.float32),
                           device=model.device)


def compute_motion_metrics(model: cm.CharModel, motion: md.MotionData,
                           jerk_threshold: float = 11666.39,
                           final_node_xyz: Optional[np.ndarray] = None,
                           contact_eps: float = 0.04) -> MotionMetrics:
    """Quality metrics for one clip on its terrain.

    jerk_threshold default matches the reference's max_jerk in
    compute_losses.py:81.
    """
    frames = _frames(model, motion)
    fps = float(motion.fps)
    body_pos, body_rot = _body_positions(model, frames)

    vel = (body_pos[1:] - body_pos[:-1]) * fps
    acc = (vel[1:] - vel[:-1]) * fps
    jerk = (acc[1:] - acc[:-1]) * fps
    jerk_mag = torch.linalg.norm(jerk, dim=-1)
    empty = jerk_mag.numel() == 0

    # contact / penetration losses against the motion's terrain
    contact_loss = pen_loss = 0.0
    if motion.terrain is not None:
        terrain = motion.terrain.to_device(model.device)
        bidx = model.contact_point_body
        pts = body_pos[..., bidx, :]
        pts = pts + rot.quat_rotate(
            body_rot[..., bidx, :],
            model.contact_point_offset.expand(pts.shape))
        ground = terrain_lib.get_hf_val_bilinear(terrain, pts[..., 0:2])
        h_above = pts[..., 2] - model.contact_point_radius - ground
        pen_loss = (torch.mean(torch.clamp(-h_above, min=0.0) ** 2)
                    * 1e3).item()
        if motion.contacts is not None:
            contacts = torch.as_tensor(np.asarray(motion.contacts),
                                       device=model.device)
            # a body's lowest contact point; a body with none gets inf
            # (jnp.min over an all-inf row), which tags as inf loss
            owner = bidx[None, :] == torch.arange(
                model.num_bodies, device=model.device)[:, None]   # (B, P)
            per_body_min = torch.where(owner[None], h_above[..., None, :],
                                       torch.inf).amin(dim=-1)
            cdist = torch.where(
                contacts > 0.5,
                torch.clamp(per_body_min - contact_eps, min=0.0), 0.0)
            contact_loss = (torch.mean(cdist ** 2) * 1e3).item()

    final_node_dist = None
    if final_node_xyz is not None:
        # distance of the avg foot position to the final path node
        feet = [i for i, n in enumerate(model.body_names) if "foot" in n]
        foot_pos = torch.mean(body_pos[-1, feet, 0:2], dim=0)
        node = torch.as_tensor(np.asarray(final_node_xyz[:2], np.float32),
                               device=model.device)
        final_node_dist = torch.linalg.norm(foot_pos - node).item()

    return MotionMetrics(
        motion_length=float(frames.shape[0] / fps),
        mean_jerk=0.0 if empty else torch.mean(jerk_mag).item(),
        max_jerk=0.0 if empty else torch.max(jerk_mag).item(),
        frames_with_jerk_over=0.0 if empty else float(
            torch.sum(jerk_mag.amax(dim=-1) > jerk_threshold).item()),
        contact_loss=contact_loss,
        pen_loss=pen_loss,
        final_node_dist=final_node_dist,
    )


def evaluate_motion_dir(model: cm.CharModel, motion_dir: str,
                        csv_path: Optional[str] = None,
                        jerk_threshold: float = 11666.39) -> List[Dict]:
    """Metrics for every clip in a directory; optional CSV export
    (reference: compute_losses.compute_csv_row)."""
    rows = []
    for fname in sorted(os.listdir(motion_dir)):
        if not fname.endswith((".npz", ".pkl")):
            continue
        motion = md.load_motion_data(os.path.join(motion_dir, fname))
        m = compute_motion_metrics(model, motion, jerk_threshold)
        rows.append({"file": fname, **m.as_dict()})
    if csv_path and rows:
        with open(csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    return rows


def dataset_statistics(model: cm.CharModel,
                       motions: Sequence[md.MotionData]) -> Dict[str, float]:
    """Dataset-wide body velocity/acceleration/jerk distribution summary
    (reference: compute_stats.py — these feed the guidance thresholds)."""
    vels, accs, jerks = [], [], []
    for motion in motions:
        fps = float(motion.fps)
        body_pos, _ = _body_positions(model, _frames(model, motion))
        v = (body_pos[1:] - body_pos[:-1]) * fps
        a = (v[1:] - v[:-1]) * fps
        j = (a[1:] - a[:-1]) * fps
        vels.append(torch.linalg.norm(v, dim=-1).reshape(-1))
        accs.append(torch.linalg.norm(a, dim=-1).reshape(-1))
        jerks.append(torch.linalg.norm(j, dim=-1).reshape(-1))
    out = {}
    for name, parts in [("speed", vels), ("acc", accs), ("jerk", jerks)]:
        arr = torch.cat(parts).cpu().numpy()
        out[f"max_{name}"] = float(arr.max()) if arr.size else 0.0
        out[f"mean_{name}"] = float(arr.mean()) if arr.size else 0.0
        out[f"p99_{name}"] = float(np.quantile(arr, 0.99)) if arr.size else 0.0
    return out


def guidance_params_from_stats(stats: Dict[str, float]):
    """Derive speed/acc/jerk guidance limits from dataset statistics the
    way the reference hard-codes them (diffusion_util.py:52-57)."""
    from parc_torch.diffusion.guidance import GuidanceParams
    ms = stats["max_speed"]
    ma = stats["max_acc"]
    mj = stats["max_jerk"]
    return GuidanceParams(
        guide_speed=True, guide_acc=True, guide_jerk=True,
        max_speed=ms, max_acc=ma, max_jerk=mj,
        w_speed=1.0 / max(ms, 1e-6), w_acc=1.0 / max(ma, 1e-6),
        w_jerk=1.0 / max(mj, 1e-6))
