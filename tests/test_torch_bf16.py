"""The bf16 trunks of parc_torch.learning.networks, and the MDM
denoiser's bf16 encoder stack, against the same weights in f32. The file
imports no JAX, so its cuda-marked tests run on a GPU machine with
``-m cuda --noconftest``.

bf16 keeps 8 bits of mantissa: the actor mean and the value agree with f32
to 2 % of their scale at the tracker's widths (3x2048 trunks over the
1312-wide obs), and the denoiser's output to 2 % of its largest magnitude
at the small config of tests/test_mdm.py (2 layers, d_model 64).
"""

import pytest
import torch

from parc_torch.data.humanoid import humanoid_spec
from parc_torch.diffusion.transformer import MDMTransformer
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
    env = DeepMimicEnv(humanoid_spec().build(device="cpu"), engine.SimParams(),
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
    env = DeepMimicEnv(humanoid_spec().build(device="cpu"), engine.SimParams(),
                       EnvConfig(num_envs=2), device=cuda)
    agent = PPOAgent(env, PPOConfig(), device=cuda)
    assert agent.net.actor_trunk.compute_dtype == torch.bfloat16


def _mdm_bf16_vs_f32(device, batch):
    """The denoiser with its encoder stack in bf16 against f32: every
    encoder layer's output is bf16, the denoiser's output f32, and the
    error above 0 (a stack that silently ran in f32 fails) and below 2 %."""
    small = dict(frame_dim=91, d_model=64, num_heads=4, d_hid=64,
                 num_layers=2)
    f32 = MDMTransformer(**small, generator=torch.Generator().manual_seed(0),
                         device="cpu").to(device)
    bf16 = MDMTransformer(**small, compute_dtype=torch.bfloat16,
                          device=device)
    bf16.load_state_dict(f32.state_dict())
    g = torch.Generator().manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=g).to(device)

    args = (randn(batch, 15, 91), torch.randint(0, 1001, (batch,),
                                                generator=g).to(device),
            randn(batch, 2, 91), 0.3 * randn(batch, 31, 31),
            randn(batch, 2))
    seen = []
    hooks = [layer.register_forward_hook(
        lambda m, i, o: seen.append(o.dtype)) for layer in bf16.layers]
    with torch.no_grad():
        want, got = f32(*args), bf16(*args)
    for h in hooks:
        h.remove()
    assert seen == [torch.bfloat16] * len(bf16.layers)
    assert got.dtype == want.dtype == torch.float32
    err = float((got - want).abs().max() / want.abs().max())
    assert 0.0 < err < TOL, err


def test_mdm_bf16_encoder_cpu():
    _mdm_bf16_vs_f32(torch.device("cpu"), 8)


@pytest.mark.cuda
def test_mdm_bf16_encoder_on_card(cuda):
    _mdm_bf16_vs_f32(cuda, 64)
