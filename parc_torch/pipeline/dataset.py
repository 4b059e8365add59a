"""Dataset pipeline: class-balanced dataset YAML + library loading.

Builds a dataset manifest from folders of motion clips with class-balanced
duration-proportional sampling weights, filters oversized terrains and
high-loss clips, and precomputes terrain masks for clips missing them.

Reference parity: PARC/util/create_dataset.py:40-202 +
parc_5_create_dataset.py. ``.npz`` clips and reference ``.pkl`` clips are
read (anim/motion_data.load_motion_data); a clip that cannot be read is
skipped with a message.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import yaml

from parc_torch import resolve_device
from parc_torch.anim import char_model as cm
from parc_torch.anim import motion_data as md
from parc_torch.anim import motion_lib as ml
from parc_torch.utils import rotation as rot
from parc_torch.utils import terrain as terrain_lib


@dataclasses.dataclass
class DatasetConfig:
    max_terrain_cells: int = 45        # reference caps terrain at 45x45
    min_motion_weight: float = 0.01
    max_contact_loss: float = 3.0
    max_pen_loss: float = 8.0
    max_total_loss: float = 30.0
    # precompute hf_mask/hf_maxmin/hf_mask_inds for clips missing them
    # (reference: PARC/util/create_dataset.py:148-163)
    precompute_masks: bool = True


def _clip_files(folder: str) -> List[str]:
    npz = glob.glob(os.path.join(folder, "*.npz"))
    # a .pkl whose mask-precomputed .npz sibling exists was already
    # converted by a previous create_dataset pass (_persist_clip): listing
    # both would double the clip's frames and sampling weight
    stems = {os.path.splitext(p)[0] for p in npz}
    pkl = [p for p in glob.glob(os.path.join(folder, "*.pkl"))
           if os.path.splitext(p)[0] not in stems]
    return sorted(npz + pkl)


def scan_motion_files(root_dir: str) -> Dict[str, List[str]]:
    """Map class-name (subfolder) -> clip files (.npz/.pkl)."""
    classes: Dict[str, List[str]] = {}
    for sub in sorted(os.listdir(root_dir)):
        full = os.path.join(root_dir, sub)
        if os.path.isdir(full):
            files = _clip_files(full)
            if files:
                classes[sub] = files
    if not classes:  # flat folder = one class
        files = _clip_files(root_dir)
        if files:
            classes["default"] = files
    return classes


def _frame_contact_points(model: cm.CharModel,
                          frames34: np.ndarray) -> torch.Tensor:
    """(T, P, 3) world positions of the character contact-point cloud, on
    ``model``'s device."""
    frames34 = torch.as_tensor(np.asarray(frames34, np.float32),
                               device=model.device)
    root_rot = rot.exp_map_to_quat(frames34[:, 3:6])
    joint_rot = cm.dof_to_rot(model, frames34[:, 6:])
    body_pos, body_rot = cm.forward_kinematics(
        model, frames34[:, 0:3], root_rot, joint_rot)
    bidx = model.contact_point_body
    return (body_pos[:, bidx, :]
            + rot.quat_rotate(body_rot[:, bidx, :],
                              model.contact_point_offset.expand(
                                  body_pos[:, bidx, :].shape)))


def precompute_terrain_masks(model: cm.CharModel,
                             clip: md.MotionData) -> bool:
    """Fill in missing motion-aware terrain masks on ``clip``:
    ``terrain.hf_mask`` / ``terrain.hf_maxmin`` (augmentation bounds that
    pin cells the motion touched) and per-frame ``hf_mask_inds``, computed
    on ``model``'s device.

    Without these, ingested clips silently get the free +-3 m augmentation
    bounds, defeating the motion-aware-augmentation guarantee (reference:
    PARC/util/create_dataset.py:148-163, util/terrain_util.py:1951-2047).
    Returns True when anything was computed (caller should persist).
    """
    t = clip.terrain
    if t is None:
        return False
    if (t.hf_mask is not None and t.hf_maxmin is not None
            and clip.hf_mask_inds is not None):
        return False
    pts = _frame_contact_points(model, clip.frames)        # (T, P, 3)
    dev = t.to_device(model.device)
    if t.hf_mask is None or t.hf_maxmin is None:
        mask = (dev.hf_mask if t.hf_mask is not None
                else terrain_lib.compute_hf_mask_inds(dev, pts))
        dev2 = terrain_lib.compute_hf_maxmin(dev, pts, mask=mask)
        t.hf_mask = dev2.hf_mask.cpu().numpy()
        if t.hf_maxmin is None:
            t.hf_maxmin = dev2.hf_maxmin.cpu().numpy()
    if clip.hf_mask_inds is None:
        ij = terrain_lib.get_grid_index(dev, pts[..., 0:2].reshape(-1, 2))
        ij = ij.reshape(pts.shape[0], -1, 2).cpu().numpy()
        clip.hf_mask_inds = [np.unique(f, axis=0).astype(np.int32)
                             for f in ij]
    return True


def _persist_clip(path: str, clip: md.MotionData) -> str:
    """Write a clip back to disk; ``.pkl`` inputs become ``.npz`` siblings
    (a foreign pickle is never rewritten)."""
    if not path.endswith(".npz"):
        path = path.rsplit(".", 1)[0] + ".npz"
    md.save_motion_data(path, clip)
    return path


def create_dataset_yaml(root_dir: str, out_path: str,
                        cfg: DatasetConfig = DatasetConfig(),
                        model: Optional[cm.CharModel] = None,
                        device="cuda") -> str:
    """Write a motions.yaml with class-balanced sampling weights.

    Per class, clip weight is proportional to duration and normalized so
    every class sums to 1/num_classes; undersized weights are floored at
    min_motion_weight (reference: PARC/util/create_dataset.py:118-137).
    Clips with terrain but missing motion-aware masks get
    ``hf_mask``/``hf_maxmin``/``hf_mask_inds`` precomputed (on ``device``,
    or on ``model``'s when one is given) and persisted; set
    ``cfg.precompute_masks=False`` for a manifest-only rebuild.
    """
    classes = scan_motion_files(root_dir)
    entries = []
    num_classes = max(len(classes), 1)
    if cfg.precompute_masks and model is None:
        from parc_torch.data.humanoid import humanoid_spec
        model = humanoid_spec().build(device=resolve_device(device))
    if not cfg.precompute_masks:
        model = None
    for cls, files in classes.items():
        durations, kept = [], []
        for f in files:
            try:
                clip = md.load_motion_data(f)
            except Exception as e:  # unreadable clip: reported, skipped
                print(f"skipping {f}: {e}")
                continue
            if clip.terrain is not None:
                h, w = clip.terrain.hf.shape
                if max(h, w) > cfg.max_terrain_cells:
                    continue
            # drop high-loss generated clips (reference:
            # PARC/util/create_dataset.py:118-137 filters on clip 'loss')
            if clip.losses is not None:
                if (clip.losses.get("contact", 0.0) > cfg.max_contact_loss
                        or clip.losses.get("pen", 0.0) > cfg.max_pen_loss
                        or clip.losses.get("total", 0.0)
                        > cfg.max_total_loss):
                    continue
            if model is not None and clip.frames.shape[-1] == 34:
                try:
                    if precompute_terrain_masks(model, clip):
                        f = _persist_clip(f, clip)
                except Exception as e:  # reported; the clip stays listed
                    print(f"mask precompute failed for {f}: {e}")
            durations.append(clip.length)
            kept.append(f)
        total = sum(durations) or 1.0
        for f, dur in zip(kept, durations):
            w = max(dur / total / num_classes, cfg.min_motion_weight
                    / max(len(kept), 1))
            entries.append({"file": os.path.abspath(f),
                            "weight": float(w), "class": cls})
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        yaml.safe_dump({"motions": entries}, f)
    return out_path


def load_dataset(model: cm.CharModel, yaml_path: str,
                 device="cuda") -> ml.MotionLib:
    """Load a dataset manifest into a MotionLib on ``device``."""
    with open(yaml_path) as f:
        manifest = yaml.safe_load(f)
    files = [entry["file"] for entry in manifest["motions"]]
    weights = [float(entry.get("weight", 1.0))
               for entry in manifest["motions"]]
    return ml.load_motion_lib(model, files, weights, device=device)


def dataset_meta(yaml_path: str) -> Dict[str, list]:
    """Host-side manifest metadata aligned with the MotionLib motion ids:
    clip names, class labels, file paths (for fail-rate tables; reference:
    dm_env.py:786-845 logs per-motion and per-class rates by name)."""
    with open(yaml_path) as f:
        manifest = yaml.safe_load(f)
    names, classes, files = [], [], []
    for entry in manifest["motions"]:
        files.append(entry["file"])
        names.append(os.path.splitext(os.path.basename(entry["file"]))[0])
        classes.append(entry.get("class", "default"))
    return {"names": names, "classes": classes, "files": files}


def ensure_terrains(model: cm.CharModel,
                    clips: Sequence[md.MotionData]) -> None:
    """Give terrain-less clips a flat terrain fitted to the motion."""
    from parc_torch.anim import motion_edit
    for clip in clips:
        if clip.terrain is None:
            clip.terrain = motion_edit.terrain_from_motion(
                model, clip.frames)
