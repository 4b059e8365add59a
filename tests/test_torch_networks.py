"""parc_torch.learning (networks, normalizer, the PPO agent's act) against
parc_tpu.learning, with the flax weights carried over by
convert.actor_critic_from_flax.

Tolerance 1e-5: a 2x512 MLP in f32 on both sides (the flax kernels are
perturbed so every weight, the VARIABLE log-std head included, is
nonzero).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.envs.base import EnvConfig as JEnvConfig
from parc_tpu.envs.deepmimic import DeepMimicEnv as JEnv
from parc_tpu.learning import normalizer as jnorm
from parc_tpu.learning import ppo as jppo
from parc_tpu.learning.networks import ActorCritic as JActorCritic
from parc_tpu.physics import engine as je
from parc_torch import convert
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.envs.base import EnvConfig as TEnvConfig
from parc_torch.envs.deepmimic import DeepMimicEnv as TEnv
from parc_torch.learning import normalizer as tnorm
from parc_torch.learning import ppo as tppo
from parc_torch.learning.networks import ActorCritic, build_net
from parc_torch.physics import engine as te

from test_torch_diffusion import jit

torch.set_num_threads(1)

OBS_DIM, ACT_DIM, NET = 1312, 28, "fc_2layers_512units"


def _flax_params(std_type, seed=0):
    net = JActorCritic(action_dim=ACT_DIM, actor_net=NET, critic_net=NET,
                       actor_std_type=std_type)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, OBS_DIM)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda p: np.asarray(p) + rng.normal(0, 0.01, np.shape(p)).astype(
            np.float32), params)
    return net, params


@pytest.fixture(scope="module")
def obs():
    return np.random.default_rng(1).normal(size=(16, OBS_DIM)).astype(np.float32)


@pytest.mark.parametrize("std_type", ["FIXED", "CONSTANT", "VARIABLE"])
def test_actor_critic_from_flax(std_type, obs):
    jnet, params = _flax_params(std_type)
    mean_j, logstd_j, value_j = jit(jnet.apply)(params, obs)
    net = convert.actor_critic_from_flax(params, actor_std_type=std_type)
    with torch.no_grad():
        mean_t, logstd_t, value_t = net(torch.as_tensor(obs))
    for got, want in ((mean_t, mean_j), (logstd_t, logstd_j),
                      (value_t, value_j)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5)


def test_init_scales():
    """The port's init follows flax's: LeCun-normal trunks (std
    1/sqrt(fan_in), truncated at 2 sd), a small uniform actor head."""
    g = torch.Generator().manual_seed(0)
    net = ActorCritic(OBS_DIM, ACT_DIM, actor_net=NET, critic_net=NET,
                      generator=g)
    w0 = net.actor_trunk[0].weight.detach()
    std = 1.0 / np.sqrt(OBS_DIM)
    assert abs(float(w0.std()) / std - 1.0) < 0.05
    assert float(w0.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6
    limit = np.sqrt(3 * 0.01 / ((512 + ACT_DIM) / 2))
    assert float(net.actor_head.weight.detach().abs().max()) <= limit
    assert float(net.actor_trunk[0].bias.detach().abs().max()) == 0.0
    with torch.no_grad():
        mean, logstd = net.actor(torch.zeros(2, OBS_DIM))
    np.testing.assert_allclose(logstd.numpy(), np.log(0.05), rtol=1e-6)
    with pytest.raises(KeyError):
        build_net("fc_9layers", OBS_DIM)


def test_normalizer(obs):
    mask = (np.arange(OBS_DIM) < 1000).astype(np.float32)
    js = jnorm.create(OBS_DIM, mask)
    ts = tnorm.create(OBS_DIM, mask, device="cpu")
    rng = np.random.default_rng(2)
    for _ in range(3):
        batch = rng.normal(3.0, 2.0, (5, 16, OBS_DIM)).astype(np.float32)
        js = jit(jnorm.update)(js, batch)
        ts = tnorm.update(ts, torch.as_tensor(batch))
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-5)
    np.testing.assert_allclose(
        tnorm.normalize(ts, torch.as_tensor(obs)).numpy(),
        np.asarray(jnorm.normalize(js, obs)), atol=1e-5)
    np.testing.assert_allclose(
        tnorm.unnormalize(ts, torch.as_tensor(obs)).numpy(),
        np.asarray(jnorm.unnormalize(js, obs)), atol=1e-5)
    carried = convert.normalizer_from_numpy(jax.tree.map(np.asarray, js))
    assert torch.equal(carried.mean, torch.as_tensor(np.array(js.mean)))
    assert carried.clip == js.clip


def test_agent_act(obs):
    cfg_j = jppo.PPOConfig(actor_net=NET, critic_net=NET)
    jenv = JEnv(jspec().build(), je.SimParams(), JEnvConfig(num_envs=16))
    jagent = jppo.PPOAgent(jenv, cfg_j)
    tenv = TEnv(tspec().build(device="cpu"), te.SimParams(), TEnvConfig(num_envs=16),
                device="cpu")
    cfg_t = tppo.PPOConfig(actor_net=NET, critic_net=NET)
    tagent = tppo.PPOAgent(tenv, cfg_t, device="cpu")
    np.testing.assert_allclose(tagent.a_mid.numpy(), jagent.a_mid, atol=1e-7)
    np.testing.assert_allclose(tagent.a_scale.numpy(), jagent.a_scale,
                               atol=1e-7)

    _, params = _flax_params("FIXED", seed=3)
    mask = (~jenv.obs_layout.non_norm_mask()).astype(np.float32)
    nj = jnorm.create(OBS_DIM, mask)
    nj = jnorm.update(nj, np.random.default_rng(4).normal(
        1.0, 3.0, (64, OBS_DIM)).astype(np.float32))
    jstate = jppo.AgentState(params=params, opt_state=None, obs_norm=nj,
                             env_state=None, rng=None, sample_count=None)
    want = jagent.act(jstate, jnp.asarray(obs))

    tagent.net = convert.actor_critic_from_flax(params)
    tstate = tppo.AgentState(
        obs_norm=convert.normalizer_from_numpy(jax.tree.map(np.asarray, nj)),
        env_state=None, sample_count=torch.zeros(()))
    got = tagent.act(tstate, torch.as_tensor(obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # a stochastic action draws from the generator around the mean
    g = torch.Generator().manual_seed(0)
    noisy = tagent.act(tstate, torch.as_tensor(obs), generator=g,
                       deterministic=False)
    spread = float(((noisy - got) / tagent.a_scale).std())
    assert 0.03 < spread < 0.07  # action_std = 0.05
