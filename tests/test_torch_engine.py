"""parc_torch.physics.engine (+ the control-step kernel's plain version
and its packed wrapper) against parc_tpu.physics.engine on the CPU.

The JAX side runs the XLA path the CPU takes (aba_level_parallel, batched
FK); each reference is jitted once. Tolerances:
* PD torques 3e-4, as the JAX package pins its own torque port
  (tests/test_pallas.py:100); at limit-violating states rtol 2e-4 /
  atol 5e-3 (tests/test_pallas.py:153-159: |tau| reaches 1.5e3 there);
* control-step state 2e-4 (tests/test_pallas.py:190-193); contact forces
  also get rtol 1e-5, the f32 rounding of a 1e3 N sum of point forces
  (index_add_ here, a one-hot einsum there). After a control step the
  forces get atol 2e-3 N instead of 2e-4: the 8000 N/m contact stiffness
  turns one f32 ulp of a contact point's height (2.4e-7 m at 2-4 m from
  the origin) into 1.9e-3 N;
* ABA accelerations rtol 1e-4 / atol 1e-3 (tests/test_physics.py pins
  the JAX package's two ABA forms to each other at this tolerance).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.anim import char_model as jcm
from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.physics import engine as je
from parc_tpu.utils import terrain as jterrain
from parc_torch.anim import char_model as tcm
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.physics import engine as te
from parc_torch.physics import substep as tsub
from parc_torch.utils import rotation as trot
from parc_torch.utils import terrain as tterrain

from test_torch_diffusion import jit

torch.set_num_threads(1)

N = 8
H = 1.0 / 120.0
STATE_FIELDS = ("root_pos", "joint_rot", "dof_vel", "body_pos")


@pytest.fixture(scope="module")
def models():
    return jspec().build(), tspec().build(device="cpu")


def _state_arrays(jm, seed, limit_push=False, z=(0.55, 0.75), spread=1.0):
    """Numpy inputs of a batch of N states (plus PD targets): root height
    drawn from ``z``, dofs from ``spread`` times their limit range."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(jm.dof_limits_lower)
    hi = np.asarray(jm.dof_limits_upper)
    mid, half = (lo + hi) / 2, np.maximum(hi - lo - 0.1, 0.0) / 2
    dof = rng.uniform(mid - spread * half, mid + spread * half,
                      size=(N, 28)).astype(np.float32)
    if limit_push:  # alternate rows past the upper / lower limits
        dof = np.where(np.arange(N)[:, None] % 2 == 0,
                       hi + rng.uniform(0.05, 0.3, (N, 28)),
                       lo - rng.uniform(0.05, 0.3, (N, 28))).astype(np.float32)
    root_rot = rng.normal(0, 0.05, (N, 4)).astype(np.float32)
    root_rot[:, 3] = 1.0
    root_rot /= np.linalg.norm(root_rot, axis=-1, keepdims=True)
    root_pos = np.zeros((N, 3), np.float32)
    root_pos[:, :2] = rng.normal(0, 0.5, (N, 2))
    root_pos[:, 2] = rng.uniform(*z, N)
    return dict(
        root_pos=root_pos, root_rot=root_rot,
        joint_rot=np.array(jcm.dof_to_rot(jm, jnp.asarray(dof))),
        root_vel=rng.normal(0, 0.5, (N, 3)).astype(np.float32),
        root_ang_vel=rng.normal(0, 0.5, (N, 3)).astype(np.float32),
        dof_vel=rng.normal(0, 2.0 if limit_push else 1.0, (N, 28)).astype(np.float32),
        act=rng.normal(0, 0.4, (N, 28)).astype(np.float32))


def _both_states(jm, tm, arrs):
    keys = ("root_pos", "root_rot", "joint_rot", "root_vel", "root_ang_vel",
            "dof_vel")
    js = jit(lambda *a: je.create_state(jm, *a))(
        *[jnp.asarray(arrs[k]) for k in keys])
    ts = te.create_state(tm, *[arrs[k] for k in keys], device="cpu")
    return js, ts


@pytest.fixture(scope="module")
def nominal(models):
    jm, tm = models
    arrs = _state_arrays(jm, 0)
    return arrs, *_both_states(jm, tm, arrs)


@pytest.fixture(scope="module")
def standing(models):
    """Near-standing states with the feet in the ground: contact forces
    then depend smoothly on the state (deep random penetration turns
    f32 rounding of positions into N-scale force differences through
    the 8000 N/m contact stiffness)."""
    jm, tm = models
    arrs = _state_arrays(jm, 2, z=(0.84, 0.9), spread=0.15)
    return arrs, *_both_states(jm, tm, arrs)


@pytest.fixture(scope="module")
def terrains():
    """A stacked 2-terrain heightfield (bumpy + slanted) per env index."""
    rng = np.random.default_rng(7)
    hf0 = rng.uniform(0.0, 0.12, (16, 16)).astype(np.float32)
    hf1 = (np.arange(16)[:, None] * 0.02 + np.zeros((1, 14))).astype(np.float32)
    mps = np.asarray([[-3.2, -3.2], [-3.0, -2.8]], np.float32)
    jts = jterrain.stack_terrains([
        jterrain.create_terrain(16, 16, dx=0.4).replace(
            hf=jnp.asarray(hf0), min_point=jnp.asarray(mps[0])),
        jterrain.create_terrain(16, 14, dx=0.4).replace(
            hf=jnp.asarray(hf1), min_point=jnp.asarray(mps[1]))])
    tts = tterrain.stack_terrains([
        tterrain.Terrain(hf=torch.as_tensor(hf0), hf_mask=None,
                         hf_maxmin=None, min_point=torch.as_tensor(mps[0]),
                         dxdy=torch.tensor([0.4, 0.4])),
        tterrain.Terrain(hf=torch.as_tensor(hf1), hf_mask=None,
                         hf_maxmin=None, min_point=torch.as_tensor(mps[1]),
                         dxdy=torch.tensor([0.4, 0.4]))])
    tidx = np.arange(N) % 2
    return jts, tts, tidx


def _close(got, want, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol, err_msg=msg)


def test_stacked_terrain_matches(terrains):
    jts, tts, _ = terrains
    np.testing.assert_array_equal(tts.hf.numpy(), np.asarray(jts.hf))
    np.testing.assert_array_equal(tts.min_point.numpy(),
                                  np.asarray(jts.min_point))


@pytest.mark.parametrize("mode", te.CONTROL_MODES)
def test_joint_torques_all_modes(models, nominal, mode):
    jm, tm = models
    arrs, js, ts = nominal
    jp = je.SimParams(control_mode=mode)
    tp = te.SimParams(control_mode=mode)
    tau_j, dex_j = jit(lambda s, a: je.compute_joint_torques(
        jm, jp, s, a, H))(js, jnp.asarray(arrs["act"]))
    tau_t, dex_t = te.compute_joint_torques(tm, tp, ts,
                                            torch.as_tensor(arrs["act"]), H)
    _close(tau_t, tau_j, 3e-4, msg=mode)
    _close(dex_t, dex_j, 1e-6, msg=mode)


@pytest.mark.parametrize("hard", [True, False], ids=["hard", "soft"])
def test_joint_torques_at_limits(models, hard):
    jm, tm = models
    arrs = _state_arrays(jm, 5, limit_push=True)
    js, ts = _both_states(jm, tm, arrs)
    act = np.zeros((N, 28), np.float32)
    jp = je.SimParams(hard_joint_limits=hard)
    tp = te.SimParams(hard_joint_limits=hard)
    tau_j, dex_j = jit(lambda s, a: je.compute_joint_torques(
        jm, jp, s, a, H))(js, jnp.asarray(act))
    tau_t, dex_t = te.compute_joint_torques(tm, tp, ts, torch.as_tensor(act), H)
    _close(tau_t, tau_j, 5e-3, 2e-4)
    _close(dex_t, dex_j, 1e-5, 2e-4)
    assert float(tau_t.abs().max()) > 10.0  # the limit torque is active


def test_contact_forces(models, nominal, terrains):
    jm, tm = models
    _, js, ts = nominal
    jts, tts, tidx = terrains
    params = je.SimParams()
    fj, nj = jit(lambda s, t: je.compute_contact_forces(
        jm, params, jts, s, t))(js, jnp.asarray(tidx, jnp.int32))
    ft, nt = te.compute_contact_forces(tm, te.SimParams(), tts, ts,
                                       torch.as_tensor(tidx))
    assert float(nt[..., 2].abs().max()) > 50.0  # points do penetrate
    _close(ft, fj, 2e-4, 1e-5)
    _close(nt, nj, 2e-4, 1e-5)
    # single (unstacked) terrain path
    j1 = jterrain.create_terrain(16, 16, dx=0.4, min_x=-3.2, min_y=-3.2)
    t1 = tterrain.create_terrain(16, 16, dx=0.4, min_x=-3.2, min_y=-3.2,
                                 device="cpu")
    fj1, _ = jit(lambda s: je.compute_contact_forces(
        jm, params, j1, s))(js)
    ft1, _ = te.compute_contact_forces(tm, te.SimParams(), t1, ts)
    _close(ft1, fj1, 2e-4, 1e-5)


def test_aba(models, nominal):
    jm, tm = models
    _, js, ts = nominal
    rng = np.random.default_rng(1)
    tau = rng.normal(size=(N, 28)).astype(np.float32)
    dex = rng.uniform(0, 0.1, (N, 28)).astype(np.float32)
    fext = rng.normal(size=(N, 15, 6)).astype(np.float32)
    ra_j, q_j = jit(lambda s, a, b, c: je.aba_level_parallel(
        jm, je.SimParams(), s, a, b, c, H))(js, tau, dex, fext)
    ra_t, q_t = te.aba(tm, te.SimParams(), ts, torch.as_tensor(tau),
                       torch.as_tensor(dex), torch.as_tensor(fext))
    _close(ra_t, ra_j, 1e-3, 1e-4)
    _close(q_t, q_j, 1e-3, 1e-4)


@pytest.fixture(scope="module")
def jax_control_step(models, standing, terrains):
    """The JAX control step from the standing state, compiled once for
    the tests that hold the port's control step and its packed plain
    version against it."""
    jm, _ = models
    arrs, js, _ = standing
    jts, _, tidx = terrains
    return jit(lambda s, a, t: je.control_step(
        jm, je.SimParams(), jts, s, a, terrain_idx=t))(
            js, jnp.asarray(arrs["act"]), jnp.asarray(tidx, jnp.int32))


def test_control_step(models, standing, terrains, jax_control_step):
    jm, tm = models
    arrs, js, ts = standing
    jts, tts, tidx = terrains
    want = jax_control_step
    got = te.control_step(tm, te.SimParams(), tts, ts,
                          torch.as_tensor(arrs["act"]),
                          terrain_idx=torch.as_tensor(tidx))
    for f in STATE_FIELDS + ("root_rot", "body_rot", "body_vel",
                             "body_ang_vel", "root_vel", "root_ang_vel"):
        _close(getattr(got, f), getattr(want, f), 2e-4, msg=f)
    assert float(got.contact_forces.abs().max()) > 50.0
    _close(got.contact_forces, want.contact_forces, 2e-3, 1e-5)


def test_substep_reference_matches_sim_step(models, standing, terrains):
    """One substep of the kernel's plain version (contact, then the
    substep, on packed arrays) == one substep of the JAX sim_step
    (substeps=1, dt=h)."""
    jm, tm = models
    arrs, js, ts = standing
    jts, tts, tidx = terrains
    jp = je.SimParams(dt=H, substeps=1)
    want = jit(lambda s, a, t: je.sim_step(
        jm, jp, jts, s, a, terrain_idx=t))(
            js, jnp.asarray(arrs["act"]), jnp.asarray(tidx, jnp.int32))
    tp = te.SimParams(dt=H, substeps=1)
    ls, lc = tsub.state_layout(tm), tsub.const_layout(tm)
    act = torch.as_tensor(arrs["act"])
    state_p = tsub.pack(ls, vars(ts), N)
    const_p = tsub.pack(lc, {"act": act, "qtar": tcm.dof_to_rot(tm, act)}, N)
    args = (tm, tp, tts, state_p, const_p,
            torch.as_tensor(tidx, dtype=torch.int32), 1)
    out, contact = tsub.control_step_packed_reference(*args)
    for f, _ in ls.fields:
        _close(tsub.unpack(out, ls, f), getattr(want, f), 2e-4, msg=f)
    _close(contact.t().reshape(N, -1, 3), want.contact_forces, 2e-3, 1e-5)
    # the CPU wrapper runs the same plain version, and counts no launch
    before = tsub.control_step_packed.launches
    out2, contact2 = tsub.control_step_packed(*args)
    assert torch.equal(out, out2) and torch.equal(contact, contact2)
    assert tsub.control_step_packed.launches == before


def test_control_step_packed_reference_matches_jax(models, standing,
                                                   terrains,
                                                   jax_control_step):
    """A whole control step (2 sim steps x 2 substeps) of the kernel's
    plain version on packed arrays == the JAX control_step."""
    jm, tm = models
    arrs, js, ts = standing
    jts, tts, tidx = terrains
    want = jax_control_step
    ls, lc = tsub.state_layout(tm), tsub.const_layout(tm)
    act = torch.as_tensor(arrs["act"])
    out, contact = tsub.control_step_packed_reference(
        tm, te.SimParams(), tts, tsub.pack(ls, vars(ts), N),
        tsub.pack(lc, {"act": act, "qtar": tcm.dof_to_rot(tm, act)}, N),
        torch.as_tensor(tidx, dtype=torch.int32), 2)
    for f, _ in ls.fields:
        _close(tsub.unpack(out, ls, f), getattr(want, f), 2e-4, msg=f)
    assert float(contact.abs().max()) > 50.0
    _close(contact.t().reshape(N, -1, 3), want.contact_forces, 2e-3, 1e-5)


def test_substep_wrapper_rejects_bad_inputs(models, nominal, terrains):
    """control_step_packed raises on a bad dtype, shape, layout, control
    mode, step count or device."""
    _, tm = models
    _, _, ts = nominal
    _, tts, tidx = terrains
    ls, lc = tsub.state_layout(tm), tsub.const_layout(tm)
    state_p = tsub.pack(ls, vars(ts), N)
    const_p = torch.zeros(lc.total, N)
    tidx = torch.as_tensor(tidx, dtype=torch.int32)
    p = te.SimParams()

    def call(state=state_p, const=const_p, idx=tidx, params=p, steps=2,
             terrain=tts):
        return tsub.control_step_packed(tm, params, terrain, state, const,
                                        idx, steps)
    with pytest.raises(TypeError):
        call(state=state_p.double())
    with pytest.raises(TypeError):
        call(idx=tidx.long())
    with pytest.raises(ValueError):
        call(state=state_p[:, :4])
    with pytest.raises(ValueError):
        call(const=const_p.t().contiguous().t())
    with pytest.raises(ValueError):
        call(idx=tidx[:4])
    with pytest.raises(ValueError):
        call(idx=None)  # a stacked terrain needs an index per env
    with pytest.raises(ValueError):
        call(params=te.SimParams(control_mode="nope"))
    with pytest.raises(ValueError):
        call(steps=0)
    with pytest.raises(ValueError):
        call(state=state_p.to("meta"), const=const_p.to("meta"),
             idx=tidx.to("meta"), terrain=dataclasses.replace(
                 tts, hf=tts.hf.to("meta"),
                 min_point=tts.min_point.to("meta"),
                 dxdy=tts.dxdy.to("meta")))


def test_layout_pack_roundtrip(models, nominal):
    _, tm = models
    _, _, ts = nominal
    ls = tsub.state_layout(tm)
    assert ls.total == 292 and tsub.const_layout(tm).total == 84
    packed = tsub.pack(ls, vars(ts), N)
    assert packed.shape == (292, N) and packed.is_contiguous()
    for f, _ in ls.fields:
        assert torch.equal(tsub.unpack(packed, ls, f), getattr(ts, f))


def test_where_state(models, nominal):
    _, tm = models
    _, _, ts = nominal
    other = ts.replace(root_pos=ts.root_pos + 1.0)
    mask = torch.arange(N) % 2 == 0
    mixed = te.where_state(mask, other, ts)
    assert torch.equal(mixed.root_pos[mask], other.root_pos[mask])
    assert torch.equal(mixed.root_pos[~mask], ts.root_pos[~mask])
    assert torch.equal(mixed.body_pos, ts.body_pos)


# ---------------------------------------------------------------------------
# analytic checks of tests/test_physics.py, run on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flat_terrain():
    return tterrain.create_terrain(64, 64, dx=0.4, min_x=-12.8, min_y=-12.8,
                                   device="cpu")


def _default_state(tm, batch=(), z=0.95):
    root_pos = torch.zeros(batch + (3,))
    root_pos[..., 2] = z
    root_rot = torch.zeros(batch + (4,))
    root_rot[..., 3] = 1.0
    joint_rot = torch.zeros(batch + (tm.num_bodies - 1, 4))
    joint_rot[..., 3] = 1.0
    return te.create_state(tm, root_pos, root_rot, joint_rot, device="cpu")


def test_free_fall_analytic(models, flat_terrain):
    """With no torques and no contact, ABA gives a pure -g root
    acceleration and no joint acceleration; 0.5 s of flight is ballistic."""
    _, tm = models
    passive = tm.replace(dof_stiffness=torch.zeros_like(tm.dof_stiffness),
                         dof_damping=torch.zeros_like(tm.dof_damping))
    params = te.SimParams(limit_stiffness=0.0, limit_damping=0.0)
    state = _default_state(passive, z=100.0)
    zero = torch.zeros(passive.dof_size)
    root_acc, qdd = te.aba(passive, params, state, zero, zero,
                           torch.zeros(passive.num_bodies, 6))
    np.testing.assert_allclose(root_acc[0:3].numpy(), 0.0, atol=1e-3)
    np.testing.assert_allclose(root_acc[3:6].numpy(), [0, 0, -9.81], atol=1e-3)
    np.testing.assert_allclose(qdd.numpy(), 0.0, atol=2e-3)
    for _ in range(30):
        state = te.sim_step(passive, params, flat_terrain, state, zero)
    t = 30 * params.dt
    assert abs(float(state.root_pos[2]) - (100.0 - 0.5 * 9.81 * t * t)) < 5e-2


def test_standing_supports_weight(models, flat_terrain):
    """PD holding the default pose supports the body: joints hold their
    targets and the ground reaction equals gravity (0.5 s horizon)."""
    _, tm = models
    state = _default_state(tm, batch=(4,), z=0.95)
    target = torch.zeros(4, tm.dof_size)
    for _ in range(15):
        state = te.control_step(tm, te.SimParams(), flat_terrain, state, target)
    z = state.root_pos[..., 2].numpy()
    assert np.all(np.isfinite(state.root_pos.numpy()))
    assert np.all(z > 0.8) and np.all(z < 1.0), z
    total_fz = state.contact_forces[..., 2].sum(-1).numpy()
    weight = float(tm.body_mass.sum()) * 9.81
    np.testing.assert_allclose(total_fz, weight, rtol=0.35)
    dof = tcm.rot_to_dof(tm, state.joint_rot).numpy()
    assert np.all(np.abs(dof) < 0.25), np.max(np.abs(dof))


def test_unbalanced_statue_topples(models, flat_terrain):
    """Without a balance controller a slightly tilted humanoid falls.

    The fall bounces chaotically (both packages' trajectories part after
    ~1 s, and a bounce can lift the pelvis again), so the check is that
    the pelvis drops below 0.6 m within 3 s, not where it is at 3 s."""
    _, tm = models
    state = _default_state(tm, z=0.95)
    tilt = trot.exp_map_to_quat(torch.tensor([0.05, 0.0, 0.0]))
    state = te.refresh_kinematics(
        tm, state.replace(root_rot=trot.quat_mul(tilt, state.root_rot)))
    target = torch.zeros(tm.dof_size)
    lowest = float(state.root_pos[2])
    for _ in range(90):  # 3 seconds
        state = te.control_step(tm, te.SimParams(), flat_terrain, state, target)
        lowest = min(lowest, float(state.root_pos[2]))
    assert np.all(np.isfinite(state.root_pos.numpy()))
    assert lowest < 0.6
