"""Online A* + MDM replanning from the character's current pose.

Slice the terrain between the character and a target, plan a route with
A*, generate a kinematic motion along it with the MDM (conditioned on the
character's last frames), and package the best rollout as a clip and a
one-clip MotionLib that a tracking env can swap in: the interactive "plan
a new parkour route from where I am" loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from parc_torch.anim import motion_data as md
from parc_torch.anim import motion_lib as ml
from parc_torch.diffusion.mdm import MDM, MDMState
from parc_torch.procgen import astar, mdm_path


@dataclasses.dataclass
class AStarMDMSettings:
    slice_pad: int = 10                  # cells around the start/end bbox
    astar: astar.AStarSettings = dataclasses.field(
        default_factory=astar.AStarSettings)
    path: mdm_path.PathGenSettings = dataclasses.field(
        default_factory=lambda: mdm_path.PathGenSettings(
            batch_size=4, max_seconds=20.0))
    save_path: Optional[str] = None      # optional clip dump (.npz)


def astar_mdm_replan(mdm: MDM, state: MDMState, terrain: md.HostTerrain,
                     prev_frames34: np.ndarray, prev_contacts: np.ndarray,
                     target_xy: np.ndarray,
                     generator: Optional[torch.Generator],
                     cfg: AStarMDMSettings = AStarMDMSettings(),
                     draws: Optional[mdm_path.PathDraws] = None
                     ) -> Optional[Tuple[md.MotionData, ml.MotionLib]]:
    """Plan and generate a new reference motion from the current pose.

    Args:
      terrain: the env's host terrain.
      prev_frames34: (num_prev, 34) the character's most recent frames.
      prev_contacts: (num_prev, num_bodies).
      target_xy: (2,) world target.
      generator: draws the windows' noise (on the MDM's device) unless
        ``draws`` gives it (``mdm_path.PathDraws``).
    Returns:
      (clip, one-clip MotionLib on the MDM's device) of the rollout with
      the least loss, or None when A* finds no path.
    """
    hf = np.asarray(terrain.hf)
    minp = np.asarray(terrain.min_point[:2], np.float32)
    dxdy = np.asarray(terrain.dxdy[:2], np.float32)
    dims = np.asarray(hf.shape)

    def cell(xy):
        return np.clip(np.round((xy - minp) / dxdy).astype(int), 0, dims - 1)

    start_ij = cell(np.asarray(prev_frames34[-1, 0:2], np.float32))
    end_ij = cell(np.asarray(target_xy))
    # slice the terrain to the padded start/end bounding box
    lo = np.maximum(np.minimum(start_ij, end_ij) - cfg.slice_pad, 0)
    hi = np.minimum(np.maximum(start_ij, end_ij) + cfg.slice_pad + 1, dims)
    hf_slice = hf[lo[0]:hi[0], lo[1]:hi[1]]
    slice_min = minp + lo * dxdy

    path = astar.run_a_star(hf_slice, dxdy, tuple(start_ij - lo),
                            tuple(end_ij - lo), cfg.astar)
    if path is None:
        return None
    nodes = astar.path_to_world(path, slice_min, dxdy, hf_slice)
    host = md.HostTerrain(hf=hf_slice.astype(np.float32),
                          min_point=slice_min.astype(np.float32), dxdy=dxdy)
    result = mdm_path.generate_frames_along_path(
        mdm, state, host.to_device(mdm.device), nodes,
        np.asarray(prev_frames34, np.float32),
        np.asarray(prev_contacts, np.float32), generator, cfg.path,
        draws=draws)

    best = int(np.argmin(result.total_loss))
    t = int(result.lengths[best])
    clip = md.MotionData(
        frames=np.asarray(result.frames34[best, :t], np.float32),
        fps=cfg.path.fps, loop_mode=md.CLAMP,
        contacts=np.asarray(result.contacts[best, :t], np.float32),
        terrain=host)
    if cfg.save_path:
        md.save_motion_data(cfg.save_path, clip)
    return clip, ml.build_motion_lib(mdm.model, [clip], device=mdm.device)
