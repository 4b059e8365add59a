"""The character loader and the second character in parc_torch against
parc_tpu, on the CPU: ``export_mjcf``, ``parse_mjcf`` / ``load_char_file``
(with .obj and binary .stl mesh assets), ``clamp_dof``, the quadruped
(``data/quadruped.py``), the fidelity clips of ``data/synthetic.py``, and
the plain engine's control step on the quadruped.

Tolerances: the exported text equal; every CharModel field equal (names,
topology) or within 1e-6 relative (the port builds its tables in float64
and stores float32, as the JAX package does); clamp_dof and the clips
equal; the control step from the JAX state, one step at a time, at 2e-4
on the state (tests/test_pallas.py:190-193) and 2e-3 N + rtol 1e-5 on the
contact forces (tests/test_torch_engine.py: 2500 N/m here times an f32 ulp
of a contact point's height is well inside it). Where f32 itself is less
accurate than 2e-4 (on these states the port's own f32 step is up to
1.9e-4 off its float64 evaluation in a body's angular velocity, and the
JAX package's 2.0e-4), the state is held within twice the port's own f32
error against float64, as chip_smoke.py holds the kernel.
"""

import dataclasses
import struct

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.anim import char_model as jcm
from parc_tpu.data import quadruped as jquad
from parc_tpu.data import synthetic as jsyn
from parc_tpu.data.humanoid import humanoid_spec as jhum
from parc_tpu.physics import engine as je
from parc_tpu.utils import terrain as jterrain
from parc_torch import convert
from parc_torch.anim import char_model as tcm
from parc_torch.data import quadruped as tquad
from parc_torch.data import synthetic as tsyn
from parc_torch.data.humanoid import humanoid_spec as thum
from parc_torch.physics import engine as te
from parc_torch.physics import substep as tsub
from parc_torch.utils import terrain as tterrain

from test_torch_diffusion import jit

torch.set_num_threads(1)

N = 8
SPECS = {"humanoid": (thum, jhum),
         "quadruped": (tquad.quadruped_spec, jquad.quadruped_spec)}
STATE_FIELDS = ("root_pos", "root_rot", "root_vel", "root_ang_vel",
                "joint_rot", "dof_vel", "body_pos", "body_rot", "body_vel",
                "body_ang_vel")
# contact parameters scaled to the ~11 kg robot (tests/test_physics.py:
# 246-249)
ROBOT = dict(contact_stiffness=2500.0, contact_damping=100.0,
             max_contact_force=400.0)

MESH_MJCF = """
<mujoco model="meshchar">
  <asset>
    <mesh name="tet_obj" file="tetra.obj"/>
    <mesh name="tet_stl" file="tetra.stl" scale="2 2 2"/>
  </asset>
  <worldbody>
    <body name="root" pos="0 0 1">
      <freejoint/>
      <geom type="mesh" mesh="tet_obj"/>
      <body name="arm" pos="0.3 0 0">
        <joint name="arm_j" axis="0 1 0" range="-90 90"/>
        <geom type="mesh" mesh="tet_stl" pos="0.1 0 0" quat="0.9 0 0.43 0"/>
      </body>
    </body>
  </worldbody>
  <actuator><motor joint="arm_j" gear="50"/></actuator>
</mujoco>"""


def assert_models_equal(got: tcm.CharModel, want):
    """Every field of a port CharModel against a JAX one."""
    for f in dataclasses.fields(got):
        if f.name == "derived":
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, torch.Tensor):
            b = np.asarray(b)
            assert a.shape == b.shape, f.name
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7,
                                       err_msg=f.name)
        else:
            assert tuple(a) == tuple(b) if isinstance(a, tuple) else a == b, \
                f.name


@pytest.mark.parametrize("name", ["humanoid", "quadruped"])
def test_export_and_parse_mjcf(tmp_path, name):
    """The spec builds the JAX package's model; its MJCF export is the JAX
    package's text; the port parses the JAX-exported file into the model
    the JAX package parses from it."""
    tspec, jspec = SPECS[name]
    assert_models_equal(tspec().build(device="cpu"), jspec().build())
    text = jcm.export_mjcf(jspec())
    assert tcm.export_mjcf(tspec()) == text
    path = tmp_path / f"{name}.xml"
    path.write_text(text)
    got = tcm.load_char_file(str(path), device="cpu")
    assert_models_equal(got, jcm.load_char_file(str(path)))
    if name == "quadruped":
        assert got.num_bodies == 13 and got.dof_size == 12
        assert set(got.joint_types[1:]) == {tcm.HINGE}


def test_parse_mesh_assets(tmp_path):
    """Mesh assets load from an .obj and a binary .stl (scaled, placed
    and rotated by the geom); every field of the spec's mesh geoms and of
    the built model against the JAX package's
    (tests/test_char_model.py:152-220)."""
    (tmp_path / "tetra.obj").write_text(
        "v 0 0 0\nv 0.2 0 0\nv 0 0.2 0\nv 0 0 0.2\n"
        "f 1 2 3\nf 1 2 4\nf 1 3 4\nf 2 3 4\n")
    tris = [((0, 0, 0), (0.2, 0, 0), (0, 0.2, 0)),
            ((0, 0, 0), (0.2, 0, 0), (0, 0, 0.2)),
            ((0, 0, 0), (0, 0.2, 0), (0, 0, 0.2)),
            ((0.2, 0, 0), (0, 0.2, 0), (0, 0, 0.2))]
    blob = b"\0" * 80 + struct.pack("<I", len(tris))
    for t in tris:
        blob += struct.pack("<3f", 0, 0, 1)
        for v in t:
            blob += struct.pack("<3f", *v)
        blob += b"\0\0"
    (tmp_path / "tetra.stl").write_bytes(blob)
    path = tmp_path / "char.xml"
    path.write_text(MESH_MJCF)
    for ext in ("obj", "stl"):
        np.testing.assert_array_equal(
            tcm.load_mesh_vertices(str(tmp_path / f"tetra.{ext}")),
            jcm.load_mesh_vertices(str(tmp_path / f"tetra.{ext}")))
    got, want = tcm.parse_mjcf(str(path)), jcm.parse_mjcf(str(path))
    for gb, wb in zip(got.bodies, want.bodies, strict=True):
        assert (gb.name, gb.parent, gb.pos, gb.quat) == \
            (wb.name, wb.parent, wb.pos, wb.quat)
        assert dataclasses.asdict(gb.joint) == dataclasses.asdict(wb.joint)
        for gg, wg in zip(gb.geoms, wb.geoms, strict=True):
            assert (gg.kind, gg.pos, gg.quat, gg.density) == \
                (wg.kind, wg.pos, wg.quat, wg.density)
            np.testing.assert_array_equal(gg.verts, wg.verts)
    assert_models_equal(tcm.load_char_file(str(path), device="cpu"),
                        jcm.load_char_file(str(path)))
    assert tcm.export_mjcf(got) == jcm.export_mjcf(want)


def test_clamp_dof():
    """clamp_dof with and without a margin, on dofs past both limits."""
    for tspec, jspec in SPECS.values():
        tm, jm = tspec().build(device="cpu"), jspec().build()
        rng = np.random.default_rng(0)
        lo = np.asarray(jm.dof_limits_lower)
        hi = np.asarray(jm.dof_limits_upper)
        dof = rng.uniform(lo - 0.5, hi + 0.5, (16, lo.size)).astype(
            np.float32)
        for margin in (0.0, 0.05):
            got = tcm.clamp_dof(tm, torch.as_tensor(dof), margin=margin)
            want = np.asarray(jcm.clamp_dof(jm, jnp.asarray(dof),
                                            margin=margin))
            np.testing.assert_array_equal(got.numpy(), want)
            assert (got.numpy() != dof).any()


def test_fidelity_clips():
    """platform_clip and gap_jump_clip: frames, contacts and terrains."""
    for name, kw in (("platform_clip", dict(step_h=0.25)),
                     ("gap_jump_clip", dict(gap_w=0.6))):
        for args in ({}, kw):
            got = getattr(tsyn, name)(**args)
            want = getattr(jsyn, name)(**args)
            assert got.fps == want.fps
            for f in ("frames", "contacts"):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f))
            for f in ("hf", "min_point", "dxdy"):
                np.testing.assert_array_equal(getattr(got.terrain, f),
                                              getattr(want.terrain, f))


def _bumpy(rng):
    """Two stacked 16 x 16 heightfields of 0.4 m cells, bumps to 3 cm."""
    hfs = [rng.uniform(0.0, 0.03, (16, 16)).astype(np.float32)
           for _ in range(2)]
    mps = np.asarray([[-3.2, -3.2], [-3.0, -2.8]], np.float32)
    jts = jterrain.stack_terrains([
        jterrain.create_terrain(16, 16, dx=0.4).replace(
            hf=jnp.asarray(h), min_point=jnp.asarray(m))
        for h, m in zip(hfs, mps)])
    tts = tterrain.stack_terrains([
        tterrain.Terrain(hf=torch.as_tensor(h), hf_mask=None, hf_maxmin=None,
                         min_point=torch.as_tensor(m),
                         dxdy=torch.tensor([0.4, 0.4]))
        for h, m in zip(hfs, mps)])
    return jts, tts


@pytest.mark.parametrize("mode", ["pd_implicit", "pd_1d"])
def test_quadruped_control_step(mode):
    """The plain engine's control step on the quadruped (8 envs near the
    standing pose, feet in a bumpy stacked terrain) against the JAX
    package's, 5 steps, each from the JAX state before it; the state
    within 2e-4, or twice the port's own f32 error against float64."""
    jm, tm = jquad.quadruped_spec().build(), tquad.quadruped_spec().build(device="cpu")
    rng = np.random.default_rng(1)
    stand = tquad.standing_pose_dof()
    dof = (stand + rng.normal(0, 0.15, (N, 12))).astype(np.float32)
    root_rot = rng.normal(0, 0.05, (N, 4)).astype(np.float32)
    root_rot[:, 3] = 1.0
    root_rot /= np.linalg.norm(root_rot, axis=-1, keepdims=True)
    root_pos = np.zeros((N, 3), np.float32)
    root_pos[:, :2] = rng.uniform(-1.5, 1.5, (N, 2))
    root_pos[:, 2] = rng.uniform(0.28, 0.31, N)
    js = je.create_state(
        jm, jnp.asarray(root_pos), jnp.asarray(root_rot),
        jcm.dof_to_rot(jm, jnp.asarray(dof)),
        jnp.asarray(rng.normal(0, 0.3, (N, 3)), jnp.float32),
        jnp.asarray(rng.normal(0, 0.3, (N, 3)), jnp.float32),
        jnp.asarray(rng.normal(0, 1.0, (N, 12)), jnp.float32))
    act = (stand + rng.normal(0, 0.1, (N, 12))).astype(np.float32)
    jts, tts = _bumpy(rng)
    tidx = np.arange(N) % 2
    step = jit(lambda s: je.control_step(
        jm, je.SimParams(control_mode=mode, **ROBOT), jts, s,
        jnp.asarray(act), terrain_idx=jnp.asarray(tidx, jnp.int32)))
    tparams = te.SimParams(control_mode=mode, **ROBOT)

    def f64(x):
        return x.double() if x.is_floating_point() else x
    tm64 = tm.replace(**{k: f64(v) for k, v in vars(tm).items()
                         if isinstance(v, torch.Tensor)})
    tts64 = dataclasses.replace(tts, hf=tts.hf.double(),
                                min_point=tts.min_point.double(),
                                dxdy=tts.dxdy.double())
    peak = 0.0
    for _ in range(5):
        ts = convert.sim_state_from_numpy(jax.tree.map(np.asarray, js))
        js = step(js)
        got = te.control_step(tm, tparams, tts, ts, torch.as_tensor(act),
                              terrain_idx=torch.as_tensor(tidx))
        exact = te.control_step(
            tm64, tparams, tts64,
            te.SimState(**{k: f64(v) for k, v in vars(ts).items()}),
            torch.as_tensor(act).double(), terrain_idx=torch.as_tensor(tidx),
            step_fn=tsub.control_step_packed_reference)
        tol = max(2e-4, 2.0 * max(
            float((getattr(got, f).double() - getattr(exact, f)).abs().max())
            for f in STATE_FIELDS))
        for f in STATE_FIELDS:
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(js, f)), atol=tol,
                                       err_msg=f)
        np.testing.assert_allclose(got.contact_forces.numpy(),
                                   np.asarray(js.contact_forces), atol=2e-3,
                                   rtol=1e-5, err_msg="contact_forces")
        peak = max(peak, float(got.contact_forces.abs().max()))
    assert peak > 20.0  # the feet are in contact


def test_quadruped_stand_and_collapse():
    """The quadruped stands 30 control steps under PD and collapses in 45
    without stiffness (tests/test_physics.py:234-270), through the port's
    engine."""
    quad = tquad.quadruped_spec().build(device="cpu")
    flat = tterrain.create_terrain(64, 64, dx=0.4, min_x=-12.8, min_y=-12.8,
                                   device="cpu")
    dof = torch.as_tensor(tquad.standing_pose_dof())
    st0 = te.create_state(quad, torch.tensor([0.0, 0.0, 0.32]),
                          torch.tensor([0.0, 0.0, 0.0, 1.0]),
                          tcm.dof_to_rot(quad, dof), device="cpu")
    params = te.SimParams(**ROBOT)
    st = st0
    for _ in range(30):
        st = te.control_step(quad, params, flat, st, dof)
    assert torch.isfinite(st.root_pos).all()
    assert 0.2 < float(st.root_pos[2]) < 0.45
    passive = quad.replace(dof_stiffness=torch.zeros_like(quad.dof_stiffness))
    st = st0
    for _ in range(45):
        st = te.control_step(passive, params, flat, st, dof)
    assert float(st.root_pos[2]) < 0.2
