"""The one generator of the benchmark's traffic: motion clips, each laid
across a box terrain of its own, as kin-gen's datasets are.

A traffic file (``traffic/<name>.json``) gives every size; the seed only
reorders and redraws values inside those sizes, so every seed makes the
same amount of work. The clips follow ``parc_torch.data.synthetic``'s
standing and walking clips (copied here so that a change to the program
cannot change the traffic), turned to a heading and raised onto a plateau
of the terrain; the terrain's boxes follow kin-gen's ``gen_terrain`` for
``terrain_style="boxes"`` (``utils/terrain.add_boxes``), clamped off the
clip's path so that the reference motion stays feasible. Everything is
numpy; the drivers wrap the arrays in each side's own clip class.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

NUM_BODIES = 15   # the humanoid's bodies (contacts are per body)
FRAME_DIM = 34    # root pos (3), root rot exp-map (3), 28 dofs
FOOT_BODIES = (11, 14)


@dataclasses.dataclass
class Clip:
    frames: np.ndarray      # (T, 34) f32
    contacts: np.ndarray    # (T, 15) f32
    fps: float
    hf: np.ndarray          # (H, W) f32
    hf_maxmin: np.ndarray   # (H, W, 2) f32: per-cell max / min allowed
    min_point: np.ndarray   # (2,) f32
    dxdy: np.ndarray        # (2,) f32
    kind: str               # "walk" | "stand"


def add_boxes(rng, hf, num_boxes, box_min_height, box_max_height,
              box_min_len, box_max_len, min_angle=0.0, max_angle=2 * np.pi):
    """Stamp rotated boxes onto ``hf`` (a copy of utils/terrain.add_boxes)."""
    h, w = hf.shape
    hf = hf.copy()
    gx, gy = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    for _ in range(num_boxes):
        c = rng.uniform(0.0, 1.0, size=2) * np.asarray([h, w], np.float32)
        blen = rng.uniform(box_min_len, box_max_len, size=2)
        ang = rng.uniform(min_angle, max_angle)
        height = np.float32(rng.uniform(box_min_height, box_max_height))
        rel_x, rel_y = gx - c[0], gy - c[1]
        ca, sa = np.cos(ang), np.sin(ang)
        rx = ca * rel_x - sa * rel_y
        ry = sa * rel_x + ca * rel_y
        in_box = (np.abs(rx) < blen[0] / 2) & (np.abs(ry) < blen[1] / 2)
        hf = np.where(in_box, height, hf)
    return hf.astype(np.float32)


def _walk(n, fps, speed, phase0):
    """data/synthetic.walking_clip's gait at ``speed`` from ``phase0``,
    in the clip's own frame (walking along +x from the origin)."""
    t = np.arange(n) / fps
    frames = np.zeros((n, FRAME_DIM), np.float32)
    frames[:, 0] = speed * t
    frames[:, 2] = 0.92 + 0.02 * np.sin(2 * np.pi * 1.8 * t)
    phase = 2 * np.pi * 0.9 * (speed / 1.4) * t + phase0
    frames[:, 6 + 13] = 0.45 * np.sin(phase)
    frames[:, 6 + 22] = -0.45 * np.sin(phase)
    frames[:, 6 + 16] = 0.5 * np.maximum(np.sin(phase + np.pi), 0)
    frames[:, 6 + 25] = 0.5 * np.maximum(np.sin(phase), 0)
    frames[:, 6 + 7] = 0.2 * np.sin(phase + np.pi)
    frames[:, 6 + 10] = 0.2 * np.sin(phase)
    contacts = np.zeros((n, NUM_BODIES), np.float32)
    contacts[:, FOOT_BODIES[0]] = (np.sin(phase) < 0).astype(np.float32)
    contacts[:, FOOT_BODIES[1]] = (np.sin(phase) >= 0).astype(np.float32)
    return frames, contacts


def _stand(n):
    """data/synthetic.standing_clip: the default pose, feet down."""
    frames = np.zeros((n, FRAME_DIM), np.float32)
    frames[:, 2] = 0.94
    contacts = np.zeros((n, NUM_BODIES), np.float32)
    contacts[:, list(FOOT_BODIES)] = 1.0
    return frames, contacts


def box_clips(p: dict, seed: int) -> List[Clip]:
    """``p["clips"]`` clips, ``round(walk_share * clips)`` of them walks,
    in an order drawn from ``seed``; each on a ``terrain_dim`` square box
    terrain of its own."""
    rng = np.random.default_rng(seed)
    n_clips, n_frames, fps = p["clips"], p["frames"], float(p["fps"])
    n_walk = int(round(p["walk_share"] * n_clips))
    kinds = np.array(["walk"] * n_walk + ["stand"] * (n_clips - n_walk))
    rng.shuffle(kinds)
    dim, dx = p["terrain_dim"], float(p["terrain_dx"])
    half = dim * dx / 2.0
    min_point = np.asarray([-half, -half], np.float32)
    centers = (np.arange(dim, dtype=np.float32) + 0.0) * dx - half
    cx, cy = np.meshgrid(centers, centers, indexing="ij")
    box = p["boxes"]
    clips = []
    for kind in kinds:
        heading = rng.uniform(0.0, 2 * np.pi)
        lift = np.float32(rng.uniform(*p["plateau_height"]))
        if kind == "walk":
            speed = rng.uniform(*p["walk_speed"])
            frames, contacts = _walk(n_frames, fps, speed,
                                     rng.uniform(0.0, 2 * np.pi))
            frames[:, 0] -= frames[-1, 0] / 2.0   # centre the path
        else:
            frames, contacts = _stand(n_frames)
        c, s = np.cos(heading), np.sin(heading)
        x, y = frames[:, 0].copy(), frames[:, 1].copy()
        frames[:, 0], frames[:, 1] = c * x - s * y, s * x + c * y
        frames[:, 2] += lift
        frames[:, 5] = heading    # root exp-map: a turn about z
        # the plateau: every cell within path_clearance of the root path
        path = frames[:, None, None, 0:2]
        d2 = ((cx - path[..., 0]) ** 2 + (cy - path[..., 1]) ** 2).min(0)
        protected = d2 <= p["path_clearance"] ** 2
        hf = add_boxes(rng, np.zeros((dim, dim), np.float32), box["num"],
                       box["min_height"], box["max_height"], box["min_len"],
                       box["max_len"])
        hf = np.where(protected, lift, hf).astype(np.float32)
        maxmin = np.stack([np.where(protected, lift, hf + 3.0),
                           np.where(protected, lift, hf - 3.0)],
                          -1).astype(np.float32)
        clips.append(Clip(frames=frames, contacts=contacts, fps=fps, hf=hf,
                          hf_maxmin=maxmin, min_point=min_point,
                          dxdy=np.asarray([dx, dx], np.float32),
                          kind=str(kind)))
    return clips


GENERATORS = {"box_clips": box_clips}


def make(p: dict, seed: int) -> List[Clip]:
    """The clips of traffic file ``p`` for ``seed``."""
    return GENERATORS[p["generator"]](p, seed)


def platform_hf(p: dict, seed: int) -> np.ndarray:
    """The parkour env's shared procgen platform (envs/mgdm.py
    ``make_platform_terrain``): ``dim`` x ``dim`` cells with boxes, drawn
    from ``seed``; centred on the origin at ``dx`` a cell."""
    rng = np.random.default_rng([seed, 1])
    box = p["boxes"]
    return add_boxes(rng, np.zeros((p["dim"], p["dim"]), np.float32),
                     box["num"], box["min_height"], box["max_height"],
                     box["min_len"], box["max_len"])
