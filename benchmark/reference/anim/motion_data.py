"""Motion clip container + .npz IO and the reference .pkl loaders (numpy;
``HostTerrain.to_device`` gives the torch terrain).

A motion clip is (frames, contacts, fps, loop_mode, terrain, hf_mask_inds)
where a frame is the 34-D vector [root_pos(3), root_rot exp-map(3),
joint dof(28)] and contacts are per-body boolean-ish flags. The file
format is the one the JAX package writes, so clips are interchangeable.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import List, Optional

import numpy as np
import torch

from reference import resolve_device
from reference.utils import terrain as terrain_lib


CLAMP, WRAP = "CLAMP", "WRAP"
LOOP_MODES = {CLAMP: 0, WRAP: 1}


@dataclasses.dataclass
class HostTerrain:
    """Host-side (numpy) terrain of a clip (utils/terrain.Terrain's fields)."""

    hf: np.ndarray
    min_point: np.ndarray
    dxdy: np.ndarray
    hf_mask: Optional[np.ndarray] = None
    hf_maxmin: Optional[np.ndarray] = None

    def to_device(self, device="cuda"):
        """The terrain as a ``utils.terrain.Terrain`` on ``device`` (no
        mask: nothing protected; no bounds: +-3 m around each cell)."""
        dev = resolve_device(device)
        h = self.hf.astype(np.float32)
        mask = (self.hf_mask if self.hf_mask is not None
                else np.zeros_like(h, bool))
        maxmin = (self.hf_maxmin if self.hf_maxmin is not None
                  else np.stack([h + 3.0, h - 3.0], -1))

        def t(x, dtype=np.float32):
            return torch.as_tensor(np.asarray(x, dtype), device=dev)
        return terrain_lib.Terrain(
            hf=t(h), hf_mask=t(mask, bool), hf_maxmin=t(maxmin),
            min_point=t(self.min_point[:2]), dxdy=t(self.dxdy[:2]))


@dataclasses.dataclass
class MotionData:
    frames: np.ndarray                    # (N, 34)
    fps: float = 30.0
    loop_mode: str = CLAMP
    contacts: Optional[np.ndarray] = None  # (N, B)
    terrain: Optional[HostTerrain] = None
    hf_mask_inds: Optional[List[np.ndarray]] = None  # per-frame (K_t, 2) int
    # optional per-frame policy observations recorded alongside the motion
    obs: Optional[np.ndarray] = None       # (N, obs_dim)
    # optional generation losses ({'contact','pen','total'})
    losses: Optional[dict] = None

    @property
    def num_frames(self) -> int:
        return self.frames.shape[0]

    @property
    def length(self) -> float:
        return (self.num_frames - 1) / self.fps


def save_motion_data(path: str, motion: MotionData) -> None:
    """Save a clip as .npz (flat keys; hf_mask_inds ragged-packed)."""
    data = {
        "frames": motion.frames.astype(np.float32),
        "fps": np.float32(motion.fps),
        "loop_mode": np.int32(LOOP_MODES[motion.loop_mode]),
    }
    if motion.contacts is not None:
        data["contacts"] = motion.contacts.astype(np.float32)
    if motion.obs is not None:
        data["obs"] = motion.obs.astype(np.float32)
    if motion.losses:
        for k, v in motion.losses.items():
            data[f"loss_{k}"] = np.float32(v)
    if motion.terrain is not None:
        t = motion.terrain
        data["terrain_hf"] = t.hf.astype(np.float32)
        data["terrain_min_point"] = np.asarray(t.min_point, np.float32)
        data["terrain_dxdy"] = np.asarray(t.dxdy, np.float32)
        if t.hf_mask is not None:
            data["terrain_hf_mask"] = t.hf_mask
        if t.hf_maxmin is not None:
            data["terrain_hf_maxmin"] = t.hf_maxmin.astype(np.float32)
    if motion.hf_mask_inds is not None:
        packed = (np.concatenate(motion.hf_mask_inds, 0)
                  if motion.hf_mask_inds else np.zeros((0, 2), np.int32))
        counts = np.asarray([len(x) for x in motion.hf_mask_inds], np.int32)
        data["hf_mask_inds_packed"] = packed.astype(np.int32)
        data["hf_mask_inds_counts"] = counts
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **data)


def load_motion_data(path: str) -> MotionData:
    """Load a clip saved by :func:`save_motion_data` (.npz), or a
    reference-format .pkl clip (:func:`load_reference_pkl`)."""
    if not path.endswith(".npz"):
        return load_reference_pkl(path)
    with np.load(path, allow_pickle=False) as z:
        terrain = None
        if "terrain_hf" in z:
            terrain = HostTerrain(
                hf=z["terrain_hf"], min_point=z["terrain_min_point"],
                dxdy=z["terrain_dxdy"],
                hf_mask=z["terrain_hf_mask"] if "terrain_hf_mask" in z else None,
                hf_maxmin=(z["terrain_hf_maxmin"]
                           if "terrain_hf_maxmin" in z else None))
        hf_mask_inds = None
        if "hf_mask_inds_packed" in z:
            packed, counts = z["hf_mask_inds_packed"], z["hf_mask_inds_counts"]
            hf_mask_inds, off = [], 0
            for c in counts:
                hf_mask_inds.append(packed[off:off + c])
                off += c
        loop = {v: k for k, v in LOOP_MODES.items()}[int(z["loop_mode"])]
        return MotionData(
            frames=z["frames"], fps=float(z["fps"]), loop_mode=loop,
            contacts=z["contacts"] if "contacts" in z else None,
            terrain=terrain, hf_mask_inds=hf_mask_inds,
            obs=z["obs"] if "obs" in z else None,
            losses={k[len("loss_"):]: float(z[k])
                    for k in z.files if k.startswith("loss_")} or None)


class _Shim:
    """Generic stand-in for foreign classes inside reference pickles."""

    def __init__(self, *a, **kw):
        pass

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})


class _RefUnpickler(pickle.Unpickler):
    """Unpickles reference .pkl clips without importing reference code.

    Torch tensors resolve through the installed torch; any class from the
    reference package namespace becomes a ``_Shim`` carrying its __dict__.
    """

    _FOREIGN_PREFIXES = ("util.", "anim.", "envs.", "diffusion.", "tools.",
                         "zmotion_editing_tools.")

    def find_class(self, module, name):
        if module.startswith(self._FOREIGN_PREFIXES) or module in (
                "terrain_util", "kin_char_model"):
            return type(name, (_Shim,), {})
        return super().find_class(module, name)


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _host_terrain(t: dict) -> HostTerrain:
    """A reference SubTerrain's __dict__ as a HostTerrain."""
    return HostTerrain(
        hf=_to_numpy(t["hf"]),
        min_point=_to_numpy(t.get("min_point", np.zeros(2))),
        dxdy=_to_numpy(t.get("dxdy", np.asarray([0.4, 0.4]))),
        hf_mask=_to_numpy(t["hf_mask"]).astype(bool)
        if t.get("hf_mask") is not None else None,
        hf_maxmin=_to_numpy(t["hf_maxmin"])
        if t.get("hf_maxmin") is not None else None)


def load_reference_pkl(path: str) -> MotionData:
    """Load a reference-format motion .pkl clip."""
    with open(path, "rb") as f:
        raw = _RefUnpickler(f).load()
    if hasattr(raw, "__dict__"):  # e.g. a pickled MotionData shim
        raw = raw.__dict__.get("_data", raw.__dict__)
    frames = _to_numpy(raw["frames"]).astype(np.float32)
    contacts = (_to_numpy(raw["contacts"]).astype(np.float32)
                if "contacts" in raw else None)
    terrain = None
    if "terrain" in raw and raw["terrain"] is not None:
        terrain = _host_terrain(raw["terrain"].__dict__)
    hf_mask_inds = None
    if raw.get("hf_mask_inds") is not None:
        hf_mask_inds = [_to_numpy(x).astype(np.int32)
                        for x in raw["hf_mask_inds"]]
    lm = raw.get("loop_mode", CLAMP)
    if not isinstance(lm, str):
        lm = CLAMP if int(getattr(lm, "value", 0)) == 0 else WRAP
    losses = None
    if raw.get("loss") is not None:  # reference stores a scalar total loss
        losses = {"total": float(_to_numpy(raw["loss"]))}
    return MotionData(frames=frames, fps=float(raw.get("fps", 30)),
                      loop_mode=lm, contacts=contacts, terrain=terrain,
                      hf_mask_inds=hf_mask_inds, losses=losses)


def load_reference_terrain_pkl(path: str) -> HostTerrain:
    """Load a standalone reference SubTerrain .pkl (or the terrain of a
    motion .pkl)."""
    with open(path, "rb") as f:
        raw = _RefUnpickler(f).load()
    t = raw.__dict__ if hasattr(raw, "__dict__") else raw
    if "terrain" in t:  # a motion pkl carrying its terrain
        t = t["terrain"].__dict__
    return _host_terrain(t)
