"""Synthetic motion clips for tests, benchmarks, and smoke runs (numpy only)."""

from __future__ import annotations

import numpy as np

from parc_torch.anim import motion_data as md


def standing_clip(n: int = 90, fps: float = 30.0,
                  terrain_dim: int = 24) -> md.MotionData:
    """A clip that stands still at the default pose on flat terrain."""
    frames = np.zeros((n, 34), np.float32)
    frames[:, 2] = 0.94
    contacts = np.zeros((n, 15), np.float32)
    contacts[:, [11, 14]] = 1.0  # feet
    half = terrain_dim * 0.4 / 2.0
    terrain = md.HostTerrain(
        hf=np.zeros((terrain_dim, terrain_dim), np.float32),
        min_point=np.asarray([-half, -half]), dxdy=np.asarray([0.4, 0.4]))
    return md.MotionData(frames=frames, fps=fps, contacts=contacts,
                         terrain=terrain)


def walking_clip(n: int = 90, fps: float = 30.0, speed: float = 1.4,
                 seed: int = 0, terrain_dim: int = 32) -> md.MotionData:
    """A forward-walking clip with simple sinusoidal leg motion."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fps
    frames = np.zeros((n, 34), np.float32)
    frames[:, 0] = speed * t
    frames[:, 2] = 0.92 + 0.02 * np.sin(2 * np.pi * 1.8 * t)
    phase = 2 * np.pi * 0.9 * t
    # hips (y-axis swings) and knees
    frames[:, 6 + 13] = 0.45 * np.sin(phase)            # right hip y
    frames[:, 6 + 22] = -0.45 * np.sin(phase)           # left hip y
    frames[:, 6 + 16] = 0.5 * np.maximum(np.sin(phase + np.pi), 0)  # r knee
    frames[:, 6 + 25] = 0.5 * np.maximum(np.sin(phase), 0)          # l knee
    # small arm counterswing
    frames[:, 6 + 7] = 0.2 * np.sin(phase + np.pi)
    frames[:, 6 + 10] = 0.2 * np.sin(phase)
    contacts = np.zeros((n, 15), np.float32)
    contacts[:, 11] = (np.sin(phase) < 0).astype(np.float32)
    contacts[:, 14] = (np.sin(phase) >= 0).astype(np.float32)
    half = terrain_dim * 0.4 / 2.0
    terrain = md.HostTerrain(
        hf=np.zeros((terrain_dim, terrain_dim), np.float32),
        min_point=np.asarray([-half, -half]), dxdy=np.asarray([0.4, 0.4]))
    return md.MotionData(frames=frames, fps=fps, contacts=contacts,
                         terrain=terrain)


def platform_clip(n: int = 120, fps: float = 30.0, speed: float = 1.2,
                  step_h: float = 0.3, terrain_dim: int = 32) -> md.MotionData:
    """Walks forward and steps up onto a raised platform at x = 2 m.

    Part of the physics-fidelity clip set: exercises contact against a
    vertical height discontinuity."""
    t = np.arange(n) / fps
    frames = np.zeros((n, 34), np.float32)
    x = speed * t
    frames[:, 0] = x
    # smooth z ramp onto the platform over x in [1.7, 2.1]
    ramp = np.clip((x - 1.7) / 0.4, 0.0, 1.0)
    lift = step_h * (3 * ramp**2 - 2 * ramp**3)
    frames[:, 2] = 0.92 + lift + 0.02 * np.sin(2 * np.pi * 1.8 * t)
    phase = 2 * np.pi * 0.9 * t
    frames[:, 6 + 13] = 0.45 * np.sin(phase)
    frames[:, 6 + 22] = -0.45 * np.sin(phase)
    frames[:, 6 + 16] = 0.5 * np.maximum(np.sin(phase + np.pi), 0)
    frames[:, 6 + 25] = 0.5 * np.maximum(np.sin(phase), 0)
    contacts = np.zeros((n, 15), np.float32)
    contacts[:, 11] = (np.sin(phase) < 0).astype(np.float32)
    contacts[:, 14] = (np.sin(phase) >= 0).astype(np.float32)
    dx = 0.4
    half = terrain_dim * dx / 2.0
    hf = np.zeros((terrain_dim, terrain_dim), np.float32)
    xs = np.arange(terrain_dim) * dx - half
    hf[xs >= 2.0, :] = step_h
    terrain = md.HostTerrain(hf=hf, min_point=np.asarray([-half, -half]),
                             dxdy=np.asarray([dx, dx]))
    return md.MotionData(frames=frames, fps=fps, contacts=contacts,
                         terrain=terrain)


def gap_jump_clip(n: int = 105, fps: float = 30.0, speed: float = 2.2,
                  gap_x0: float = 2.2, gap_w: float = 0.8,
                  terrain_dim: int = 32) -> md.MotionData:
    """Runs forward and clears a 0.8 m gap with a ballistic arc.

    Part of the physics-fidelity clip set: exercises flight phase,
    landing impacts, and contact on gap edges."""
    t = np.arange(n) / fps
    frames = np.zeros((n, 34), np.float32)
    x = speed * t
    frames[:, 0] = x
    # ballistic arc: take off 0.3 m before the gap, land 0.3 m after
    x_to = gap_x0 - 0.3
    x_land = gap_x0 + gap_w + 0.3
    t_to = x_to / speed
    t_fl = (x_land - x_to) / speed
    v0 = 0.5 * 9.81 * t_fl  # returns to take-off height after t_fl
    tf = t - t_to
    in_flight = (tf >= 0) & (tf <= t_fl)
    z = 0.92 + 0.02 * np.sin(2 * np.pi * 1.8 * t)
    z = np.where(in_flight, 0.92 + v0 * tf - 0.5 * 9.81 * tf**2, z)
    frames[:, 2] = z
    phase = 2 * np.pi * 1.4 * t
    frames[:, 6 + 13] = 0.55 * np.sin(phase)
    frames[:, 6 + 22] = -0.55 * np.sin(phase)
    frames[:, 6 + 16] = 0.6 * np.maximum(np.sin(phase + np.pi), 0)
    frames[:, 6 + 25] = 0.6 * np.maximum(np.sin(phase), 0)
    # tuck both knees during flight
    frames[in_flight, 6 + 16] = 0.9
    frames[in_flight, 6 + 25] = 0.9
    contacts = np.zeros((n, 15), np.float32)
    contacts[:, 11] = ((np.sin(phase) < 0) & ~in_flight).astype(np.float32)
    contacts[:, 14] = ((np.sin(phase) >= 0) & ~in_flight).astype(np.float32)
    dx = 0.4
    half = terrain_dim * dx / 2.0
    hf = np.zeros((terrain_dim, terrain_dim), np.float32)
    xs = np.arange(terrain_dim) * dx - half
    hf[(xs >= gap_x0) & (xs < gap_x0 + gap_w), :] = -1.2
    terrain = md.HostTerrain(hf=hf, min_point=np.asarray([-half, -half]),
                             dxdy=np.asarray([dx, dx]))
    return md.MotionData(frames=frames, fps=fps, contacts=contacts,
                         terrain=terrain)
