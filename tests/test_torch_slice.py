"""The slice as a whole: the tracker rollout of parc_torch against
parc_tpu, step for step.

8 envs on the standing and a walking clip; a fc_2layers_512units
actor-critic whose flax weights are carried over; the JAX reset state and
reset pool carried over with parc_torch.convert. Three control steps in
both stacks with the same deterministic actions (the JAX policy's mean,
which the port's policy reproduces at 1e-4); obs, reward, done and the sim
state are compared after every step. Tolerances: sim state 2e-4 (the
control-step tolerance, tests/test_pallas.py:190-193), contact forces as
in tests/test_torch_engine.py (2e-3 N + rtol 1e-5), obs 2e-4, reward
1e-5, done equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.anim import motion_lib as jml
from parc_tpu.data import synthetic as jsyn
from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.envs import base as jbase
from parc_tpu.envs import deepmimic as jdm
from parc_tpu.learning import normalizer as jnorm
from parc_tpu.learning import ppo as jppo
from parc_tpu.physics import engine as je
from parc_torch import convert
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.envs import base as tbase
from parc_torch.envs import deepmimic as tdm
from parc_torch.learning import ppo as tppo
from parc_torch.physics import engine as te

from test_torch_diffusion import jit

torch.set_num_threads(1)

N, K, STEPS, NET = 8, 2, 3, "fc_2layers_512units"
STATE = ("root_pos", "root_rot", "joint_rot", "dof_vel", "body_pos",
         "body_rot", "body_vel", "body_ang_vel")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def rollouts():
    """Both stacks stepped STEPS times from the same start; returns the
    per-step (jax, torch, jax action, torch action) tuples."""
    jm = jspec().build()
    jlib = jml.build_motion_lib(jm, [jsyn.standing_clip(),
                                     jsyn.walking_clip(seed=1)])
    jenv = jdm.DeepMimicEnv(jm, je.SimParams(), jbase.EnvConfig(num_envs=N))
    jagent = jppo.PPOAgent(jenv, jppo.PPOConfig(actor_net=NET,
                                                critic_net=NET))
    jstate = jit(jagent.init)(jlib, jax.random.PRNGKey(0))
    # a normalizer that has seen data, so normalization is not identity
    obs_norm = jnorm.update(jstate.obs_norm, jnp.concatenate(
        [jstate.env_state.obs, 0.5 * jstate.env_state.obs + 0.1]))
    jpool = jit(lambda l, f: jenv.build_reset_pool(
        l, jax.random.PRNGKey(1), f, N, k=K))(jlib, jstate.env_state.fail_rates)

    @jit
    def jstep(lib, es, params, norm, pool, counts):
        mean, _ = jagent.net.apply(params, jnorm.normalize(norm, es.obs),
                                   method="actor")
        action = jagent.a_mid + jagent.a_scale * mean
        es = jenv.step(lib, es, action, reset_pool=pool,
                       pool_slot=counts % K)
        return es, counts + (es.done != 0).astype(counts.dtype), action

    tenv = tdm.DeepMimicEnv(tspec().build(device="cpu"), te.SimParams(),
                            tbase.EnvConfig(num_envs=N), device="cpu")
    tagent = tppo.PPOAgent(tenv, tppo.PPOConfig(actor_net=NET, critic_net=NET),
                           device="cpu")
    tagent.net = convert.actor_critic_from_flax(_np(jstate.params))
    tlib = convert.motion_lib_from_numpy(_np(jlib))
    tpool = convert.reset_pool_from_numpy(_np(jpool))
    tnorm = convert.normalizer_from_numpy(_np(obs_norm))
    ts = convert.env_state_from_numpy(_np(jstate.env_state))
    tstate = tppo.AgentState(obs_norm=tnorm, env_state=ts,
                             sample_count=torch.zeros(()))

    js, jcounts = jstate.env_state, jnp.zeros((N,), jnp.int32)
    tcounts = torch.zeros(N, dtype=torch.long)
    out = []
    for _ in range(STEPS):
        t_action = tagent.act(tstate.replace(env_state=ts), ts.obs)
        js, jcounts, j_action = jstep(jlib, js, jstate.params, obs_norm,
                                      jpool, jcounts)
        ts = tenv.step(tlib, ts, torch.as_tensor(np.asarray(j_action)),
                       reset_pool=tpool, pool_slot=tcounts % K)
        tcounts = tcounts + (ts.done != 0).long()
        out.append((js, ts, np.asarray(j_action), t_action))
    return out


def _close(got, want, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol, err_msg=msg)


@pytest.mark.parametrize("step", range(STEPS))
def test_policy_action(rollouts, step):
    _, _, j_action, t_action = rollouts[step]
    _close(t_action, j_action, 1e-4)


@pytest.mark.parametrize("step", range(STEPS))
def test_sim_state(rollouts, step):
    js, ts, _, _ = rollouts[step]
    for f in STATE:
        _close(getattr(ts.sim, f), getattr(js.sim, f), 2e-4, msg=f)
    _close(ts.sim.contact_forces, js.sim.contact_forces, 2e-3, 1e-5)


@pytest.mark.parametrize("step", range(STEPS))
def test_obs_reward_done(rollouts, step):
    js, ts, _, _ = rollouts[step]
    np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
    _close(ts.reward, js.reward, 1e-5, msg="reward")
    _close(ts.reward_components, js.reward_components, 1e-5)
    _close(ts.obs, js.obs, 2e-4, msg="obs")
    _close(ts.terminal_obs, js.terminal_obs, 2e-4, msg="terminal_obs")
    _close(ts.tracking_error, js.tracking_error, 2e-4)
    _close(ts.fail_rates, js.fail_rates, 1e-6)
    np.testing.assert_array_equal(ts.motion_ids.numpy(),
                                  np.asarray(js.motion_ids))
    _close(ts.motion_times, js.motion_times, 1e-6)
