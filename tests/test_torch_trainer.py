"""The tracker stage's rollouts in parc_torch (the trainer's deterministic
test rollout, the record stage) against parc_tpu's, on the CPU, from the
same flax weights, normalizer and motion library.

Tolerances: the test rollout's statistics at 1e-4 of their scale, the
recorded frames at 2e-4 (the control-step tolerance of
tests/test_pallas.py:190-193) with contacts and successes equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.anim import motion_lib as jml
from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.envs import base as jbase
from parc_tpu.envs import deepmimic as jdm
from parc_tpu.learning import normalizer as jnorm
from parc_tpu.learning import ppo as jppo
from parc_tpu.physics import engine as je
from parc_tpu.pipeline import record as jrec
from parc_tpu.pipeline import train_tracker as jtt
from parc_torch import convert
from parc_torch.anim import motion_lib as tml
from parc_torch.data import synthetic as tsyn
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.envs import base as tbase
from parc_torch.envs import deepmimic as tdm
from parc_torch.learning import ppo as tppo
from parc_torch.physics import engine as te
from parc_torch.pipeline import record as trec
from parc_torch.pipeline import train_tracker as ttt

from test_torch_diffusion import jax_jit_opt0  # noqa: F401

torch.set_num_threads(1)

NET = "fc_2layers_512units"
SMALL = dict(actor_net=NET, critic_net=NET)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_lib(lib):
    """A JAX MotionLib holding the port's (both packages' build_motion_lib
    agree, tests/test_torch_motion_lib.py; no eager JAX build to
    compile)."""
    def j(x):
        x = x.numpy()
        return jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
    return jml.MotionLib(**{k: j(v) for k, v in vars(lib).items()})


def _stacks(clips, env_kw, ppo_kw=SMALL):
    """A JAX and a port agent (same flax weights, a normalizer that has seen
    spread data) over the same clips, with their motion libraries and
    states."""
    jm = jspec().build()
    tenv = tdm.DeepMimicEnv(tspec().build(device="cpu"), te.SimParams(),
                            tbase.EnvConfig(**env_kw), device="cpu")
    tlib = tml.build_motion_lib(tenv.model, clips, device="cpu")
    jlib = _jax_lib(tlib)
    jenv = jdm.DeepMimicEnv(jm, je.SimParams(), jbase.EnvConfig(**env_kw))
    jagent = jppo.PPOAgent(jenv, jppo.PPOConfig(**ppo_kw))
    obs_dim = jenv.obs_dim
    params = jax.jit(jagent.net.init)(jax.random.PRNGKey(0),
                                      jnp.zeros((1, obs_dim)))
    rng = np.random.default_rng(2)
    spread = rng.normal(0.5, 2.0, (256, obs_dim)).astype(np.float32)
    mask = (~jenv.obs_layout.non_norm_mask()).astype(np.float32)
    norm = jnorm.update(jnorm.create(obs_dim, mask), spread)
    jstate = jppo.AgentState(params=params, opt_state=None, obs_norm=norm,
                             env_state=None, rng=None, sample_count=None)

    tagent = tppo.PPOAgent(tenv, tppo.PPOConfig(**ppo_kw), device="cpu")
    tagent.net.load_state_dict(convert.flax_state_dict(_np(params)))
    tstate = tppo.AgentState(obs_norm=convert.normalizer_from_numpy(
        _np(norm)), env_state=None, sample_count=torch.zeros(()))
    return jagent, jlib, jstate, tagent, tlib, tstate


@pytest.fixture(autouse=True)
def _opt0(jax_jit_opt0):
    """The JAX test rollout and record loop compile at level 0."""


def test_make_test_fn():
    """6 steps of the deterministic test rollout on 8 envs of a standing
    clip whose episodes end after 0.1 s (3 steps), so episodes finish,
    envs reset inline and the stop test sees two episodes per env."""
    env_kw = dict(num_envs=8, rand_reset=False, episode_length=0.1)
    jagent, jlib, jstate, tagent, tlib, tstate = _stacks(
        [tsyn.standing_clip()], env_kw)
    want = jtt.make_test_fn(jagent, 6, test_episodes=16)(
        jlib, jstate, jax.random.PRNGKey(0))
    got = ttt.make_test_fn(tagent, 6, test_episodes=16)(
        tlib, tstate, torch.Generator().manual_seed(0))
    assert set(got) == set(want)
    assert int(got["test_steps"]) == int(want["test_steps"]) == 6
    assert float(got["num_eps"]) == float(want["num_eps"]) == 16.0
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(
            got[k].double().numpy(), w, rtol=1e-4,
            atol=1e-4 * max(float(np.max(np.abs(w))), 1e-6), err_msg=k)


def test_record_motions():
    """Two clips, 8 steps at most, retried from 30 % of their length: the
    5-frame clip plays through (success), the 90-frame one cannot in 8
    steps, in both stacks and both rounds."""
    env_kw = dict(num_envs=2, rand_reset=False)
    jagent, jlib, jstate, tagent, tlib, tstate = _stacks(
        [tsyn.standing_clip(n=5), tsyn.walking_clip(seed=1)], env_kw)
    kw = dict(max_steps=8, start_fractions=(0.0, 0.3))
    want = jrec.record_motions(jagent, jlib, jstate, jrec.RecordConfig(**kw))
    got = trec.record_motions(tagent, tlib, tstate, trec.RecordConfig(**kw))
    assert [g is None for g in got] == [w is None for w in want] \
        == [False, True]
    for g, w in zip(got, want):
        if w is None:
            continue
        assert g.frames.shape == w.frames.shape and g.frames.shape[1] == 34
        np.testing.assert_allclose(g.frames, w.frames, atol=2e-4)
        np.testing.assert_array_equal(g.contacts, w.contacts)
        np.testing.assert_array_equal(g.terrain.hf, w.terrain.hf)
