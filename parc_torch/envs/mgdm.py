"""MGDM env: MDM-in-the-loop reference generation for tracker training.

Instead of replaying dataset clips, every env's reference motion is
generated by the motion diffusion model on a procedurally generated
platform terrain: every ``plan_frames`` control steps all envs replan at
once, one batched MDM call producing each env's next reference window from
its current one, toward a random xy target.

:class:`MGDMEnv` is :class:`~parc_torch.envs.parkour.ParkourEnv` with
``mgdm_num = num_envs``: the replan, the standing spawns, the targets and
the out-of-bounds termination exist once, in ParkourEnv.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from parc_torch.anim import char_model as cm
from parc_torch.anim import motion_lib as ml
from parc_torch.diffusion.mdm import MDM, MDMState
from parc_torch.envs.base import EnvConfig
from parc_torch.envs.parkour import ParkourConfig, ParkourEnv, ParkourLib
from parc_torch.physics import engine
from parc_torch.utils import terrain as terrain_lib


@dataclasses.dataclass(frozen=True)
class MGDMConfig:
    """Standalone-mgdm settings (mapped onto ParkourConfig)."""

    plan_frames: int = 15            # frames per MDM window
    target_radius: float = 3.0       # random target sampling radius
    min_target_dist: float = 1.0
    oob_z_low: float = -3.0          # out-of-bounds termination
    oob_z_high: float = 6.0
    ddim_stride: int = 20
    guidance_scale: float = 1.0
    spawn_margin_cells: int = 4


def make_platform_terrain(rng: np.random.Generator, dim: int = 64,
                          dx: float = 0.4, device="cuda"
                          ) -> terrain_lib.Terrain:
    """The global procgen platform terrain: ``dim`` x ``dim`` cells of
    ``dx`` m centered on the origin, 24 random boxes from -0.5 to 1.2 m
    high and 3 to 10 cells long (host numpy draws from ``rng``)."""
    hf = np.zeros((dim, dim), np.float32)
    hf = terrain_lib.add_boxes(rng, hf, num_boxes=24, box_min_height=-0.5,
                               box_max_height=1.2, box_min_len=3,
                               box_max_len=10)
    half = dim * dx / 2
    t = terrain_lib.create_terrain(dim, dim, dx=dx, min_x=-half, min_y=-half,
                                   device=device)
    return dataclasses.replace(t, hf=torch.as_tensor(hf, device=t.hf.device))


class MGDMEnv(ParkourEnv):
    """Generated-reference tracking env: ParkourEnv with every env in the
    mgdm fraction. Pass a :class:`ParkourLib` bundle (see
    :meth:`make_default_lib`) as ``lib``."""

    def __init__(self, model: cm.CharModel, sim_params: engine.SimParams,
                 env_cfg: EnvConfig, mgdm_cfg: MGDMConfig, mdm: MDM,
                 terrain: terrain_lib.Terrain, device="cuda"):
        pcfg = ParkourConfig(
            mgdm_num=env_cfg.num_envs,
            plan_frames=mgdm_cfg.plan_frames,
            target_radius=mgdm_cfg.target_radius,
            min_target_dist=mgdm_cfg.min_target_dist,
            ddim_stride=mgdm_cfg.ddim_stride,
            guidance_scale=mgdm_cfg.guidance_scale,
            spawn_margin_cells=mgdm_cfg.spawn_margin_cells,
            oob_z_low=mgdm_cfg.oob_z_low,
            oob_z_high=mgdm_cfg.oob_z_high)
        super().__init__(model, sim_params, env_cfg, pcfg, mdm, terrain,
                         device=device)

    def make_default_lib(self, mdm_state: MDMState,
                         lib: Optional[ml.MotionLib] = None) -> ParkourLib:
        """The bundle of a standalone mgdm run: mgdm uses no dataset
        motions, so the MotionLib (one standing clip by default) only
        carries the terrain slot and the fail-rate statistics."""
        if lib is None:
            from parc_torch.data.synthetic import standing_clip
            lib = ml.build_motion_lib(self.model, [standing_clip()],
                                      device=self.device)
        return self.make_lib(lib, mdm_state)
