"""The bf16 trunks of parc_torch.learning.networks against the same weights
in f32. The file imports no JAX, so its cuda-marked test runs on a GPU
machine with ``-m cuda --noconftest``.

bf16 keeps 8 bits of mantissa: the actor mean and the value agree with f32
to 2 % of their scale at the tracker's widths (3x2048 trunks over the
1312-wide obs).
"""

import pytest
import torch

from parc_torch.data.humanoid import humanoid_spec
from parc_torch.envs.base import EnvConfig
from parc_torch.envs.deepmimic import DeepMimicEnv
from parc_torch.learning.networks import ActorCritic
from parc_torch.learning.ppo import PPOAgent, PPOConfig
from parc_torch.physics import engine

torch.set_num_threads(1)

OBS, ACT, TOL = 1312, 28, 2e-2


def _bf16_vs_f32(device, batch):
    f32 = ActorCritic(OBS, ACT, generator=torch.Generator().manual_seed(0),
                      device="cpu").to(device)
    bf16 = ActorCritic(OBS, ACT, device=device, compute_dtype=torch.bfloat16)
    bf16.load_state_dict(f32.state_dict())
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    obs = torch.randn(batch, OBS,
                      generator=torch.Generator().manual_seed(1)).to(device)
    with torch.no_grad():
        m32, _, v32 = f32(obs)
        m16, _, v16 = bf16(obs)
    assert m16.dtype == v16.dtype == torch.float32
    with torch.no_grad():  # the trunks really compute in bf16
        assert bf16.actor_trunk(obs).dtype == torch.bfloat16
        assert bf16.critic_trunk(obs).dtype == torch.bfloat16
    for got, want in ((m16, m32), (v16, v32)):
        err = float((got - want).abs().max() / want.abs().max())
        assert 0.0 < err < TOL, err
    # gradients reach the f32 parameters through the casts
    bf16(obs)[0].sum().backward()
    grad = bf16.actor_trunk[0].weight.grad
    assert grad is not None and grad.dtype == torch.float32


def test_bf16_trunk_cpu():
    _bf16_vs_f32(torch.device("cpu"), 64)


def test_agent_uses_bf16_on_cuda_only():
    env = DeepMimicEnv(humanoid_spec().build(), engine.SimParams(),
                       EnvConfig(num_envs=2), device="cpu")
    cfg = PPOConfig(actor_net="fc_2layers_512units",
                    critic_net="fc_2layers_512units")
    assert PPOAgent(env, cfg, device="cpu").net.actor_trunk.compute_dtype \
        is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_bf16_trunk_on_card(cuda):
    _bf16_vs_f32(cuda, 4096)
    env = DeepMimicEnv(humanoid_spec().build(), engine.SimParams(),
                       EnvConfig(num_envs=2), device=cuda)
    agent = PPOAgent(env, PPOConfig(), device=cuda)
    assert agent.net.actor_trunk.compute_dtype == torch.bfloat16
