"""parc_torch.envs.parkour / mgdm against parc_tpu.envs.parkour / mgdm at
6 envs with 2 mgdm rows, on a two-clip library and a 32 x 32 platform, with
the small MDM of tests/test_parkour.py (11 diffusion steps, d_model 32;
DDIM stride 5: 3 denoiser calls a replan) carried across by
parc_torch.convert. Every random draw is made in JAX from the JAX
package's keys and handed to the port (StandingDraws, ReplanDraws); the
reset pool of the step test is the JAX package's, carried across.

The envs run without early termination, so that done flags come from the
timeouts and from the mgdm rows' out-of-bounds z test alone (a replan by
a random-weight MDM gives references that any pose test would fail).

Tolerances (f32):
- _buffer_frame with a steps axis: 1e-4 (slerped poses, as
  tests/test_torch_motion_lib.py);
- reset: standing windows and targets 1e-5, the respawned sims 1e-4, obs
  1e-4; ids, timer and flags equal;
- step, each of 5 control steps from the JAX state before it (carried
  across; a falling body's contacts amplify f32 rounding step by step): the
  state and the generated windows 2e-4 (contact forces 2e-3 + 1e-5
  relative, as tests/test_torch_engine.py) (as
  test_gen_mdm_motion_stacked_terrain), obs 2e-4, reward 1e-4, the fail
  rates 1e-6; done flags, ids, contacts of the windows equal;
- build_reset_pool: as reset;
- make_platform_terrain: the heightfield equal; the MotionLib with its
  terrain slot: equal.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.anim import motion_lib as jml
from parc_tpu.data import synthetic as jsyn
from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.diffusion.mdm import MDM as JMDM
from parc_tpu.diffusion.mdm import MDMConfig as JCfg
from parc_tpu.diffusion.mdm import MDMState as JState
from parc_tpu.envs import base as jbase
from parc_tpu.envs import mgdm as jmg
from parc_tpu.envs import parkour as jpk
from parc_tpu.physics import engine as je
from parc_torch import convert
from parc_torch.anim import char_model as tcm
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.diffusion.mdm import MDM as TMDM
from parc_torch.diffusion.mdm import MDMConfig as TCfg
from parc_torch.envs import base as tbase
from parc_torch.envs import mgdm as tmg
from parc_torch.envs import parkour as tpk
from parc_torch.physics import engine as te
from test_torch_diffusion import _close, _np, _t, jit

from test_torch_diffusion import jax_jit_opt0  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _opt0(jax_jit_opt0):
    """The JAX package's own jax.jit calls compile at level 0."""

N, NM = 6, 2
MDM_CFG = dict(diffusion_timesteps=11, d_model=32, num_heads=2, d_hid=32,
               num_layers=1)
ENV_CFG = dict(num_envs=N, enable_early_termination=False)
PCFG = dict(mgdm_num=NM, plan_frames=4, ddim_stride=5)
SIM_FIELDS = ("root_pos", "root_rot", "root_vel", "root_ang_vel",
              "joint_rot", "dof_vel", "body_pos")


def _mdms(jm, tm, tlib):
    """Both MDMs from one JAX state: flax's init, the port's feature
    stats (JAX's stats pass would compile its window sampler)."""
    jmdm = JMDM(jm, JCfg(**MDM_CFG))
    tmdm = TMDM(tm, TCfg(**MDM_CFG), device="cpu")
    ts = tmdm.init(tlib, torch.Generator().manual_seed(0), stats_samples=8)
    fd = tmdm.frame_dim
    params = jit(jmdm.net.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 15, fd)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 2, fd)),
        jnp.zeros((1, 31, 31)), jnp.zeros((1, 2)))
    js = JState(params=params, ema_params=params,
                opt_state=jmdm.tx.init(params),
                mean=jnp.asarray(ts.mean.numpy()),
                std=jnp.asarray(ts.std.numpy()), rng=jax.random.PRNGKey(1),
                step=jnp.zeros((), jnp.int32))
    return jmdm, tmdm, js, tmdm.merge_persistent(
        ts, convert.mdm_state_from_numpy(_np(js)))


@pytest.fixture(scope="module")
def stacks():
    jm, tm = jspec().build(), tspec().build(device="cpu")
    jlib = jml.build_motion_lib(jm, [jsyn.standing_clip(),
                                     jsyn.walking_clip(seed=1)])
    tlib = convert.motion_lib_from_numpy(_np(jlib))
    jmdm, tmdm, jms, tms = _mdms(jm, tm, tlib)
    jter = jmg.make_platform_terrain(np.random.default_rng(0), dim=32)
    tter = tmg.make_platform_terrain(np.random.default_rng(0), dim=32,
                                     device="cpu")
    jenv = jpk.ParkourEnv(jm, je.SimParams(), jbase.EnvConfig(**ENV_CFG),
                          jpk.ParkourConfig(**PCFG), jmdm, jter)
    tenv = tpk.ParkourEnv(tm, te.SimParams(), tbase.EnvConfig(**ENV_CFG),
                          tpk.ParkourConfig(**PCFG), tmdm, tter,
                          device="cpu")
    return dict(jenv=jenv, tenv=tenv, jb=jenv.make_lib(jlib, jms),
                tb=tenv.make_lib(tlib, tms), jlib=jlib, tlib=tlib, jms=jms,
                tms=tms, jmdm=jmdm, tmdm=tmdm)


def _targets(key, n):
    return tpk.TargetDraws(
        ang_u=_t(jax.random.uniform(key, (n,))),
        rad_u=_t(jax.random.uniform(jax.random.fold_in(key, 1), (n,))))


def _standing(key, n):
    """The draws of ParkourEnv._standing_windows(key, n)."""
    k_pos, k_tgt = jax.random.split(key)
    return tpk.StandingDraws(pos_u=_t(jax.random.uniform(k_pos, (n, 2))),
                             target=_targets(k_tgt, n))


def _replan(rng, mdm, n=NM):
    """The replan draws of ParkourEnv.step from a state's rng."""
    k_gen, k_tgt = jax.random.split(jax.random.split(rng)[1])
    noise = jax.random.normal(k_gen, (n, mdm.scfg.seq_len, mdm.frame_dim))
    return tpk.ReplanDraws(noise=_t(noise), target=_targets(k_tgt, n))


def _close_state(t, j, atol, msg=""):
    for f in SIM_FIELDS:
        _close(getattr(t.sim, f), getattr(j.sim, f), atol, f"{msg} sim.{f}")
    # contact forces of up to kN: tests/test_torch_engine.py's tolerance
    np.testing.assert_allclose(t.sim.contact_forces.numpy(),
                               np.asarray(j.sim.contact_forces), rtol=1e-5,
                               atol=2e-3, err_msg=f"{msg} contact forces")


def _close_frame(t, j, atol):
    for f in ("root_pos", "root_rot", "root_vel", "root_ang_vel",
              "joint_rot", "dof_vel", "contacts"):
        _close(getattr(t, f), getattr(j, f), atol, f)


def test_append_terrain_slot(stacks):
    """make_lib: the dataset lib with the platform's zero-weight slot, the
    terrains edge-padded to 32 x 32, and the slot's never-timing-out
    length."""
    jb, tb = stacks["jb"], stacks["tb"]
    for f in dataclasses.fields(tb.lib):
        np.testing.assert_array_equal(getattr(tb.lib, f.name).numpy(),
                                      np.asarray(getattr(jb.lib, f.name)),
                                      err_msg=f.name)
    assert tb.num_motions == 3 and tb.lib.terrain_hf.shape == (3, 32, 32)
    lib, mdm_state = stacks["tenv"]._unwrap(tb)
    assert float(lib.lengths[-1]) == 1e9 and mdm_state is stacks["tms"]
    assert float(tb.lib.lengths[-1]) == np.float32(1 / 30)


def test_buffer_frame():
    jm, tm = jspec().build(), tspec().build(device="cpu")
    rng = np.random.default_rng(0)
    clip = jsyn.walking_clip(seed=3)
    frames = np.stack([clip.frames[i:i + 15] for i in (0, 7, 20)])
    frames = (frames + rng.normal(0, 0.05, frames.shape)).astype(np.float32)
    contacts = (rng.uniform(size=(3, 15, 15)) > 0.5).astype(np.float32)
    times = rng.uniform(-0.1, 0.6, (3, 6)).astype(np.float32)
    times[0, 0], times[1, 0] = 0.0, 14 / 30  # the window's two ends
    want = jit(lambda f, c, t: jpk._buffer_frame(jm, f, c, t, 30.0))(
        frames, contacts, times)
    got = tpk._buffer_frame(tm, _t(frames), _t(contacts), _t(times), 30.0)
    _close_frame(got, want, 1e-4)
    assert got.joint_rot.shape == (3, 6, 14, 4)
    # without the steps axis
    want = jit(lambda f, c, t: jpk._buffer_frame(jm, f, c, t, 30.0))(
        frames, contacts, times[:, 2])
    _close_frame(tpk._buffer_frame(tm, _t(frames), _t(contacts),
                                   _t(times[:, 2]), 30.0), want, 1e-4)


IDS = np.asarray([0, 1, 1, 0, 0, 0], np.int32)
T0 = np.asarray([0.0, 0.5, 1.0, 0.3, 0.0, 0.0], np.float32)


@pytest.fixture(scope="module")
def reset(stacks):
    """Both envs' resets (demo mode for the dm rows), the JAX draws handed
    to the port."""
    jenv, tenv = stacks["jenv"], stacks["tenv"]
    key = jax.random.PRNGKey(1)
    js = jit(lambda b, k, i, t: jenv.reset(b, k, motion_ids=i,
                                           start_times=t))(
        stacks["jb"], key, jnp.asarray(IDS), jnp.asarray(T0))
    k_std = jax.random.split(jax.random.split(key)[0])[1]
    ts = tenv.reset(stacks["tb"], None, motion_ids=torch.as_tensor(IDS),
                    start_times=torch.as_tensor(T0),
                    draws=_standing(k_std, NM))
    return js, ts


def test_reset(reset):
    js, ts = reset
    for f in ("ref_frames34", "ref_contacts", "target_xy"):
        _close(getattr(ts, f), getattr(js, f), 1e-5, f)
    np.testing.assert_array_equal(ts.motion_ids.numpy(), [0, 1, 1, 0, 2, 2])
    np.testing.assert_array_equal(ts.motion_ids.numpy(),
                                  np.asarray(js.motion_ids))
    _close_state(ts, js, 1e-4, "reset")
    _close(ts.obs, js.obs, 1e-4, "obs")
    _close(ts.motion_times, js.motion_times, 0.0, "motion_times")
    assert ts.replan_timer == int(js.replan_timer) == 1
    _close(ts.ref_synthetic, js.ref_synthetic, 0.0, "ref_synthetic")
    # the mgdm rows stand on the platform, inside its margins
    xy = ts.sim.root_pos[N - NM:, :2]
    assert bool((xy.abs() < 16 * 0.4 - 4 * 0.4 + 1e-4).all())


def test_step_with_replans(stacks, reset, pools):
    """5 control steps with explicit actions and the JAX reset pool: the
    first and the fifth replan (plan_frames 4). Env 1 runs past the episode
    length (TIME); mgdm row 1 (env 5) is lifted 7 m (out of bounds: FAIL);
    both take their pool entry, the mgdm row its standing window."""
    jenv, tenv, jb, tb = (stacks[k] for k in ("jenv", "tenv", "jb", "tb"))
    js, _ = reset
    root = np.array(js.sim.root_pos)
    root[5, 2] += 7.0
    time = np.full((N,), 0.5, np.float32)
    time[1] = 11.0
    js = js.replace(sim=je.refresh_kinematics(
        jenv.model, js.sim.replace(root_pos=jnp.asarray(root))),
        time=jnp.asarray(time))
    fr = np.asarray(js.fail_rates)
    jpool = pools[0]
    tpool = convert.parkour_reset_pool_from_numpy(_np(jpool))
    jstep = jit(lambda b, s, a, p, k: jenv.step(b, s, a, reset_pool=p,
                                                pool_slot=k))
    act_rng = np.random.default_rng(2)
    slot = np.asarray([0, 1, 0, 1, 0, 1], np.int32)
    dones = []
    for i in range(5):
        act = act_rng.normal(0, 0.3, (N, 28)).astype(np.float32)
        draws = _replan(js.rng, stacks["jmdm"])
        prev_frames = np.asarray(js.ref_frames34)
        ts = convert.parkour_state_from_numpy(_np(js))
        js = jstep(jb, js, jnp.asarray(act), jpool, jnp.asarray(slot))
        ts = tenv.step(tb, ts, torch.as_tensor(act), reset_pool=tpool,
                       pool_slot=torch.as_tensor(slot), replan_draws=draws)
        msg = f"step {i + 1}"
        assert ts.replan_timer == int(js.replan_timer) == (4 if i in (0, 4)
                                                           else 4 - i)
        np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done),
                                      err_msg=msg)
        np.testing.assert_array_equal(ts.motion_ids.numpy(),
                                      np.asarray(js.motion_ids), err_msg=msg)
        _close_state(ts, js, 2e-4, msg)
        _close(ts.ref_frames34, js.ref_frames34, 2e-4, f"{msg} windows")
        np.testing.assert_array_equal(ts.ref_contacts.numpy(),
                                      np.asarray(js.ref_contacts),
                                      err_msg=msg)
        _close(ts.target_xy, js.target_xy, 1e-4, f"{msg} targets")
        _close(ts.ref_synthetic, js.ref_synthetic, 0.0, msg)
        _close(ts.obs, js.obs, 2e-4, f"{msg} obs")
        _close(ts.terminal_obs, js.terminal_obs, 2e-4, f"{msg} terminal obs")
        _close(ts.reward, js.reward, 1e-4, f"{msg} reward")
        _close(ts.tracking_error, js.tracking_error, 2e-4, msg)
        _close(ts.fail_rates, js.fail_rates, 1e-6, f"{msg} fail rates")
        _close(ts.motion_times, js.motion_times, 1e-6, msg)
        _close(ts.time, js.time, 1e-6, msg)
        if i in (0, 4):
            assert not np.array_equal(ts.ref_frames34.numpy(), prev_frames)
        dones.append(ts.done.numpy().copy())
    first = dones[0]
    assert first[1] == tbase.DoneFlags.TIME and first[5] == tbase.DoneFlags.FAIL
    # the killed mgdm row took its pool entry: slot 1, mgdm row 1
    assert float(ts.fail_rates[2]) != fr[2] and float(ts.fail_rates[0]) == fr[0]


@pytest.fixture(scope="module")
def pools(stacks):
    """Both envs' reset pools, k = 2 batches. The fail rates give the
    standing clip every dm row (the walk's weight is 0) and rand_reset is
    off, so the dm rows are deterministic too; the standing draws come
    from JAX."""
    jenv, tenv = stacks["jenv"], stacks["tenv"]
    env_cfg = dict(ENV_CFG, rand_reset=False)
    jenv = jpk.ParkourEnv(jenv.model, je.SimParams(),
                          jbase.EnvConfig(**env_cfg), jenv.pcfg, jenv.mdm,
                          jenv.mgdm_terrain)
    tenv = tpk.ParkourEnv(tenv.model, te.SimParams(),
                          tbase.EnvConfig(**env_cfg), tenv.pcfg, tenv.mdm,
                          tenv.mgdm_terrain, device="cpu")
    fr = np.asarray([0.5, -0.01, 0.5], np.float32)
    key = jax.random.PRNGKey(4)
    jpool = jit(lambda b, f: jenv.build_reset_pool(b, key, f, N, k=2))(
        stacks["jb"], jnp.asarray(fr))
    draws = [_standing(jax.random.split(jax.random.fold_in(key, c))[1], NM)
             for c in range(2)]
    tpool = tenv.build_reset_pool(stacks["tb"], torch.Generator(),
                                  torch.as_tensor(fr), N, k=2, draws=draws)
    return jpool, tpool


def test_build_reset_pool(pools):
    jpool, tpool = pools
    np.testing.assert_array_equal(tpool.motion_ids.numpy(),
                                  np.asarray(jpool.motion_ids))
    assert tpool.motion_ids.tolist() == [0, 0, 0, 0, 2, 2] * 2
    for f in ("times", "ref_frames34", "ref_contacts", "target_xy"):
        _close(getattr(tpool, f), getattr(jpool, f), 1e-5, f)
    _close_state(tpool, jpool, 1e-4, "pool")
    _close(tpool.obs, jpool.obs, 1e-4, "obs")
    assert tpool.k == 2


def test_mgdm_env_and_platform(stacks):
    """make_platform_terrain (the default 64 x 64 and 32 x 32) equal;
    MGDMEnv (every env an mgdm row) on its default lib: its config, lib
    and reset (the draws from JAX), then one control step with a
    replan."""
    for dim in (64, 32):
        j = jmg.make_platform_terrain(np.random.default_rng(5), dim=dim)
        t = tmg.make_platform_terrain(np.random.default_rng(5), dim=dim,
                                      device="cpu")
        for f in ("hf", "hf_mask", "hf_maxmin", "min_point", "dxdy"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)), f)
    assert float(t.hf.max()) > 0.0 and float(t.min_point[0]) == np.float32(-6.4)
    jt = jmg.make_platform_terrain(np.random.default_rng(0), dim=32)
    tt = tmg.make_platform_terrain(np.random.default_rng(0), dim=32,
                                   device="cpu")
    kw = dict(num_envs=3, enable_early_termination=False)
    mcfg = dict(ddim_stride=5, plan_frames=4)
    jenv = jmg.MGDMEnv(stacks["jenv"].model, je.SimParams(),
                       jbase.EnvConfig(**kw), jmg.MGDMConfig(**mcfg),
                       stacks["jmdm"], jt)
    tenv = tmg.MGDMEnv(stacks["tenv"].model, te.SimParams(),
                       tbase.EnvConfig(**kw), tmg.MGDMConfig(**mcfg),
                       stacks["tmdm"], tt, device="cpu")
    assert isinstance(tenv, tpk.ParkourEnv) and tenv.n_dm == 0
    jb = jenv.make_default_lib(stacks["jms"])
    tb = tenv.make_default_lib(stacks["tms"])
    for f in dataclasses.fields(tb.lib):
        _close(getattr(tb.lib, f.name), getattr(jb.lib, f.name), 1e-6,
               f.name)
    key = jax.random.PRNGKey(6)
    js = jit(lambda b, k: jenv.reset(b, k))(jb, key)
    k_std = jax.random.split(jax.random.split(key)[0])[1]
    ts = tenv.reset(tb, torch.Generator(), draws=_standing(k_std, 3))
    assert ts.motion_ids.tolist() == [1, 1, 1]
    _close_state(ts, js, 1e-4, "reset")
    _close(ts.obs, js.obs, 1e-4, "reset obs")
    # the step with no dm rows (ParkourEnv.step's, held against JAX in
    # test_step_with_replans): a replan from the synthetic windows, then
    # the rows track their generated windows
    act = torch.zeros(3, 28)
    g = torch.Generator().manual_seed(7)
    out = tenv.step(tb, ts, act, generator=g)
    assert out.replan_timer == 4 and not bool(out.ref_synthetic.any())
    assert not torch.equal(out.ref_frames34, ts.ref_frames34)
    assert out.done.tolist() == [0, 0, 0] and torch.isfinite(out.obs).all()
    _close(out.motion_times, np.full(3, 1 / 30, np.float32), 1e-7, "times")
