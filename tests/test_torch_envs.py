"""parc_torch.envs (deepmimic, obs, perception, base) against parc_tpu.envs.

Both envs run on identical states (the JAX state carried over with
convert.env_state_from_numpy, or the deterministic demo-mode reset both
packages have). Tolerances: obs 1e-4 (target frames come from slerp,
see tests/test_torch_motion_lib.py), reward 1e-5, done flags equal,
tracking error 1e-4, fail-rate EMA 1e-6.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.anim import char_model as jcm
from parc_tpu.anim import motion_lib as jml
from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.envs import base as jbase
from parc_tpu.envs import deepmimic as jdm
from parc_tpu.envs import perception as jperc
from parc_tpu.physics import engine as je
from parc_tpu.utils import rotation as jrot
from parc_torch import convert
from parc_torch.anim import char_model as tcm
from parc_torch.anim import motion_lib as tml
from parc_torch.data import synthetic as tsyn
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.envs import base as tbase
from parc_torch.envs import deepmimic as tdm
from parc_torch.envs import perception as tperc
from parc_torch.physics import engine as te

from test_torch_diffusion import jit

torch.set_num_threads(1)

N = 8


@pytest.fixture(scope="module")
def stacks():
    """Both envs over one motion library: the port's, held by the JAX one
    as well (both packages' build_motion_lib agree,
    tests/test_torch_motion_lib.py; no eager JAX build to compile)."""
    jm, tm = jspec().build(), tspec().build(device="cpu")
    tlib = tml.build_motion_lib(tm, [tsyn.standing_clip(),
                                     tsyn.walking_clip(seed=1)],
                                device="cpu")
    jlib = jml.MotionLib(**{
        k: jnp.asarray(v.numpy().astype(np.int32) if v.dtype == torch.int64
                       else v.numpy()) for k, v in vars(tlib).items()})
    cfg = dict(num_envs=N)
    jenv = jdm.DeepMimicEnv(jm, je.SimParams(), jbase.EnvConfig(**cfg))
    tenv = tdm.DeepMimicEnv(tm, te.SimParams(), tbase.EnvConfig(**cfg),
                            device="cpu")
    return jenv, tenv, jlib, tlib


@pytest.fixture(scope="module")
def states(stacks):
    """A demo-mode reset of both envs, then per-env perturbations: env 1
    displaced 0.8 m (pose/root fail), env 2 past the episode length, env 3
    past its motion's end, env 4 turned 1.6 rad (root rotation fail), env 5
    with contact forces, env 6 turned about z (heading-local obs)."""
    jenv, tenv, jlib, tlib = stacks
    ids = np.asarray([0, 1, 1, 0, 1, 0, 1, 1], np.int32)
    t0 = np.asarray([0.0, 0.5, 1.0, 2.9, 0.3, 1.2, 2.0, 0.7], np.float32)
    js = jit(lambda l, i, t: jenv.reset(l, jax.random.PRNGKey(0),
                                            motion_ids=i, start_times=t))(
        jlib, jnp.asarray(ids), jnp.asarray(t0))
    ts = tenv.reset(tlib, torch.Generator(), motion_ids=torch.as_tensor(ids),
                    start_times=torch.as_tensor(t0))

    sim = js.sim
    rng = np.random.default_rng(0)
    root_pos = np.array(sim.root_pos)
    root_pos[1, 0] += 0.8
    turn = np.array(jrot.exp_map_to_quat(jnp.asarray(
        [[0, 0, 0]] * 4 + [[1.6, 0, 0], [0, 0, 0], [0, 0, 2.5], [0, 0, 0]],
        jnp.float32)))
    root_rot = np.array(jrot.quat_mul(jnp.asarray(turn), sim.root_rot))
    dof_vel = np.array(sim.dof_vel) + rng.normal(0, 0.5, (N, 28)).astype(np.float32)
    cf = np.zeros((N, 15, 3), np.float32)
    cf[5, [11, 14], 2] = 200.0
    cf[5, 4, 0] = 0.5
    sim = je.refresh_kinematics(jenv.model, sim.replace(
        root_pos=jnp.asarray(root_pos), root_rot=jnp.asarray(root_rot),
        dof_vel=jnp.asarray(dof_vel))).replace(contact_forces=jnp.asarray(cf))
    time = np.full((N,), 0.5, np.float32)
    time[2] = 11.0
    mt = np.array(js.motion_times)
    mt[3] = 3.5
    js = js.replace(sim=sim, time=jnp.asarray(time), motion_times=jnp.asarray(mt))
    return js, ts, convert.env_state_from_numpy(jax.tree.map(np.asarray, js))


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0, err_msg=msg)


def test_layout_and_bounds(stacks):
    jenv, tenv, _, _ = stacks
    for f in ("names", "sizes", "normalized"):
        assert getattr(tenv.obs_layout, f) == getattr(jenv.obs_layout, f)
    assert tenv.obs_dim == jenv.obs_dim == 1312
    for got, want in zip(tenv.action_bounds(), jenv.action_bounds()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tenv.dof_err_w.numpy(), jenv.dof_err_w)


@pytest.mark.parametrize("mode", jperc.MODES)
def test_perception_patterns(mode):
    jcfg = jbase.EnvConfig(terrain_obs_mode=mode)
    tcfg = tbase.EnvConfig(terrain_obs_mode=mode)
    np.testing.assert_array_equal(tperc.local_pattern(tcfg),
                                  jperc.local_pattern(jcfg))
    rng = np.random.default_rng(1)
    rp = rng.normal(size=(4, 3)).astype(np.float32)
    rr = rng.normal(size=(4, 4)).astype(np.float32)
    rr /= np.linalg.norm(rr, axis=-1, keepdims=True)
    pat = jperc.local_pattern(jcfg)
    _close(tperc.sample_points(torch.as_tensor(rp), torch.as_tensor(rr),
                               torch.as_tensor(pat)),
           jperc.sample_points(jnp.asarray(rp), jnp.asarray(rr), pat), 1e-5)


def test_demo_reset_matches(states):
    js0, ts0, _ = states
    # the demo-mode reset (before the perturbations) is deterministic
    assert ts0.obs.shape == (N, 1312)
    jenv_obs = np.asarray(js0.terminal_obs)  # == obs of the reset
    _close(ts0.obs, jenv_obs, 1e-4)


def test_obs(stacks, states):
    jenv, tenv, jlib, tlib = stacks
    js, _, ts = states
    want = jit(jenv._compute_obs)(jlib, js)
    got = tenv._compute_obs(tlib, ts)
    sl = tenv.obs_layout.slices()
    for name in tenv.obs_layout.names:
        _close(got[:, sl[name]], np.asarray(want)[:, sl[name]], 1e-4, name)


def test_reward_done_tracking(stacks, states):
    jenv, tenv, jlib, tlib = stacks
    js, _, ts = states

    def jax_terms(lib, st):
        ref = jml.calc_motion_frame(lib, st.motion_ids, st.motion_times)
        bp, br = jcm.forward_kinematics(jenv.model, ref.root_pos,
                                        ref.root_rot, ref.joint_rot)
        r, c = jenv._compute_reward(st, ref, bp)
        d = jenv._compute_done(lib, st, ref, bp)
        e = jenv._tracking_error(st, ref, bp, br)
        return r, c, d, e

    r_j, c_j, d_j, e_j = jit(jax_terms)(jlib, js)
    ref = tml.calc_motion_frame(tlib, ts.motion_ids, ts.motion_times)
    bp, br = tcm.forward_kinematics(tenv.model, ref.root_pos, ref.root_rot,
                                    ref.joint_rot)
    r_t, c_t = tenv._compute_reward(ts, ref, bp)
    d_t = tenv._compute_done(tlib, ts, ref, bp)
    e_t = tenv._tracking_error(ts, ref, bp, br)
    _close(r_t, r_j, 1e-5, "reward")
    _close(c_t, c_j, 1e-5, "reward components")
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    _close(e_t, e_j, 1e-4, "tracking error")
    # the perturbations do what they are for
    assert d_t.tolist()[1:5] == [1, 3, 3, 1]
    assert float(c_t[5, 5]) != 0.0


def test_contact_termination(stacks, states):
    """With contact_bodies set, contact on other bodies plus a low body
    fails an env (the optional fall check of _compute_done)."""
    jenv, tenv, jlib, tlib = stacks
    js, _, ts = states
    kw = dict(num_envs=N, contact_bodies=("right_foot", "left_foot"),
              termination_height=1.5)
    jenv2 = jdm.DeepMimicEnv(jenv.model, je.SimParams(), jbase.EnvConfig(**kw))
    tenv2 = tdm.DeepMimicEnv(tenv.model, te.SimParams(), tbase.EnvConfig(**kw),
                             device="cpu")

    def jax_done(lib, st):
        ref_j = jml.calc_motion_frame(lib, st.motion_ids, st.motion_times)
        bp_j, _ = jcm.forward_kinematics(jenv.model, ref_j.root_pos,
                                         ref_j.root_rot, ref_j.joint_rot)
        return jenv2._compute_done(lib, st, ref_j, bp_j)
    d_j = jit(jax_done)(jlib, js)
    ref = tml.calc_motion_frame(tlib, ts.motion_ids, ts.motion_times)
    bp, _ = tcm.forward_kinematics(tenv.model, ref.root_pos, ref.root_rot,
                                   ref.joint_rot)
    d_t = tenv2._compute_done(tlib, ts, ref, bp)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert int(d_t[5]) == 1  # the lower arm touches and bodies are low


def test_step_fail_rate_ema(stacks, states):
    """One control step with the reset pool in both stacks: done flags
    equal, the per-motion fail-rate EMA at 1e-6, done envs take their
    pool entry."""
    jenv, tenv, jlib, tlib = stacks
    js, _, ts = states
    act = np.random.default_rng(2).normal(0, 0.3, (N, 28)).astype(np.float32)
    slot = np.asarray([0, 1, 0, 1, 0, 1, 0, 1], np.int32)

    def pool_and_step(l, s, a, k):  # one compile for both
        p = jenv.build_reset_pool(l, jax.random.PRNGKey(3), s.fail_rates, N,
                                  k=2)
        return p, jenv.step(l, s, a, reset_pool=p, pool_slot=k)
    jpool, j2 = jit(pool_and_step)(jlib, js, jnp.asarray(act),
                                   jnp.asarray(slot))
    tpool = convert.reset_pool_from_numpy(jax.tree.map(np.asarray, jpool))
    t2 = tenv.step(tlib, ts, torch.as_tensor(act), reset_pool=tpool,
                   pool_slot=torch.as_tensor(slot))
    np.testing.assert_array_equal(t2.done.numpy(), np.asarray(j2.done))
    assert int((t2.done != 0).sum()) >= 3
    _close(t2.fail_rates, j2.fail_rates, 1e-6, "fail_rates")
    assert not np.allclose(t2.fail_rates.numpy(), 0.5)
    _close(t2.reward, j2.reward, 1e-5, "reward")
    np.testing.assert_array_equal(t2.motion_ids.numpy(), np.asarray(j2.motion_ids))
    _close(t2.obs, j2.obs, 2e-4, "obs")
    _close(t2.time, j2.time, 1e-6, "time")
    with pytest.raises(ValueError):
        tenv.step(tlib, ts, torch.as_tensor(act))


def test_random_reset_and_inline_step(stacks):
    """The generator-driven paths (no JAX counterpart draws the same
    numbers): reset, the pool, and a step with inline resets."""
    _, tenv, _, tlib = stacks
    g = torch.Generator().manual_seed(0)
    st = tenv.reset(tlib, g)
    assert st.obs.shape == (N, 1312) and torch.isfinite(st.obs).all()
    assert st.motion_ids.dtype == torch.int64
    pool = tenv.build_reset_pool(tlib, g, st.fail_rates, N, k=3)
    assert pool.obs.shape == (3 * N, 1312) and pool.sim.root_pos.shape == (3 * N, 3)
    forced = dataclasses.replace(st, time=torch.full((N,), 20.0))
    out = tenv.step(tlib, forced, torch.zeros(N, 28), generator=g)
    assert bool((out.done == 3).all()) and bool((out.time == 0).all())
    assert torch.isfinite(out.obs).all()
