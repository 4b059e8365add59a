"""The tracker's reference: the frozen copy's DeepMimic env, plain physics
and PPO agent, built from the inputs the benchmark hands both sides (the
clips and terrains, the configuration, the env count, the seed), in float32
with TF32 off, or, as the control, with the trunks' matmuls in fp8.

The program's env and agent draw everything from one generator seeded
with the run's seed, in a fixed order (weights, reset, then per step the
action noise and exploration masks, per iteration the reset pool and the
minibatch orders); the copy makes the same draws in the same order, so
both sides see the same noise.
"""

from __future__ import annotations

import contextlib

import torch

from reference import fp8
from reference.anim import motion_data as md
from reference.anim import motion_lib as ml
from reference.data.humanoid import humanoid_spec
from reference.envs.base import EnvConfig
from reference.envs.deepmimic import DeepMimicEnv
from reference.learning.ppo import PPOAgent, PPOConfig
from reference.physics.engine import SimParams


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matmuls and convolutions, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def clip_data(clips) -> list:
    """The traffic's clips as the copy's MotionData."""
    return [md.MotionData(
        frames=c.frames, fps=c.fps, contacts=c.contacts,
        terrain=md.HostTerrain(hf=c.hf, min_point=c.min_point, dxdy=c.dxdy,
                               hf_maxmin=c.hf_maxmin)) for c in clips]


def build(clips, env_cfg: dict, sim: dict, ppo: dict, num_envs: int,
          seed: int, device, control: bool = False):
    """(agent, lib, state) of the reference, ready for ``train_iter``."""
    from harness.cfg import build as from_json  # plain config reader
    model = humanoid_spec().build(device=device)
    lib = ml.build_motion_lib(model, clip_data(clips), device=device)
    env = DeepMimicEnv(model, from_json(SimParams, sim),
                       from_json(EnvConfig, env_cfg, num_envs=num_envs),
                       device=device)
    cfg = from_json(PPOConfig, ppo, bf16_compute=False)
    agent = PPOAgent(env, cfg, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    state = agent.init(lib, g)
    if control:
        fp8.use_fp8([agent.net.actor_trunk, agent.net.critic_trunk])
    return agent, lib, state
