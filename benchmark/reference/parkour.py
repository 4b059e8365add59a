"""The parkour tracker's reference: the frozen copy's ParkourEnv (the
DeepMimic rows over the clips' terrains, the MDM rows on the shared
platform with their in-step DDIM replans), plain physics, PPO agent and
MDM, built from the inputs the benchmark hands both sides, in float32 with
TF32 off, or, as the control, with the trunks' and the denoiser's encoder
matmuls in fp8. The MDM is drawn from the seed (weights and Monte-Carlo
feature statistics, as the CLI's parkour path draws them), then the agent
and the env from a second generator with the same seed."""

from __future__ import annotations

import torch

from reference import fp8
from reference.anim import motion_lib as ml
from reference.data.humanoid import humanoid_spec
from reference.diffusion import sampler as sampler_lib
from reference.diffusion.mdm import MDM, MDMConfig
from reference.envs.base import EnvConfig
from reference.envs.parkour import ParkourConfig, ParkourEnv
from reference.learning.ppo import PPOAgent, PPOConfig
from reference.physics.engine import SimParams
from reference.tracker import clip_data
from reference.utils import terrain as terrain_lib

STATS_SAMPLES = 256  # the CLI's parkour path: a Monte-Carlo estimate


def platform(hf, dx: float, device) -> terrain_lib.Terrain:
    dim = hf.shape[0]
    half = dim * dx / 2
    t = terrain_lib.create_terrain(dim, dim, dx=dx, min_x=-half, min_y=-half,
                                   device=device)
    return terrain_lib.Terrain(
        hf=torch.as_tensor(hf, device=t.hf.device), hf_mask=t.hf_mask,
        hf_maxmin=t.hf_maxmin, min_point=t.min_point, dxdy=t.dxdy)


def build(clips, platform_hf, platform_dx, tracker_cfg: dict,
          mdm_cfg: dict, num_envs: int, mgdm_rows: int, seed: int, device,
          control: bool = False):
    """(agent, bundle, state, mdm) of the reference, ready for
    ``train_iter``."""
    from harness.cfg import build as from_json
    model = humanoid_spec().build(device=device)
    lib = ml.build_motion_lib(model, clip_data(clips), device=device)
    mdm = MDM(model, from_json(MDMConfig, mdm_cfg["mdm"], bf16_compute=False),
              from_json(sampler_lib.SamplerConfig, mdm_cfg["sampler"]),
              device=device)
    mdm_state = mdm.init(lib, torch.Generator(device=device).manual_seed(
        seed), stats_samples=STATS_SAMPLES)
    env = ParkourEnv(
        model, from_json(SimParams, tracker_cfg["sim"]),
        from_json(EnvConfig, tracker_cfg["env"], num_envs=num_envs),
        from_json(ParkourConfig, tracker_cfg["parkour"], mgdm_num=mgdm_rows),
        mdm, platform(platform_hf, platform_dx, device), device=device)
    agent = PPOAgent(env, from_json(PPOConfig, tracker_cfg["ppo"],
                                    bf16_compute=False), device=device)
    bundle = env.make_lib(lib, mdm_state)
    state = agent.init(bundle, torch.Generator(device=device).manual_seed(
        seed))
    if control:
        fp8.use_fp8([agent.net.actor_trunk, agent.net.critic_trunk,
                     mdm_state.net.layers, mdm_state.ema_net.layers])
    return agent, bundle, state, mdm
