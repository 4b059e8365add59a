"""parc_torch.anim.char_model against parc_tpu.anim.char_model.

The humanoid's tables must be equal (they are built by the same float64
host code, then stored in f32), and FK, dof<->rotation maps and body
velocities agree at 1e-5 (f32 rounding of a quaternion chain 6 deep).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.anim import char_model as jcm
from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_torch.anim import char_model as tcm
from parc_torch.data.humanoid import humanoid_spec as tspec

from test_torch_diffusion import jit

torch.set_num_threads(1)

TABLES = ("local_translation", "local_rotation", "joint_axes",
          "dof_limits_lower", "dof_limits_upper", "dof_stiffness",
          "dof_damping", "dof_armature", "dof_motor_effort", "body_mass",
          "body_com", "body_inertia", "contact_point_body",
          "contact_point_offset", "contact_point_radius", "dof_map")
TOPOLOGY = ("body_names", "joint_names", "parent_indices", "joint_types",
            "dof_offsets", "dof_size", "num_bodies")


@pytest.fixture(scope="module")
def models():
    return jspec().build(), tspec().build(device="cpu")


@pytest.fixture(scope="module")
def pose():
    rng = np.random.default_rng(0)
    n = 16
    dof = rng.uniform(-0.9, 0.9, size=(n, 28)).astype(np.float32)
    root_pos = rng.normal(size=(n, 3)).astype(np.float32)
    root_rot = rng.normal(size=(n, 4)).astype(np.float32)
    root_rot /= np.linalg.norm(root_rot, axis=-1, keepdims=True)
    return dict(dof=dof, root_pos=root_pos, root_rot=root_rot,
                root_vel=rng.normal(size=(n, 3)).astype(np.float32),
                root_ang_vel=rng.normal(size=(n, 3)).astype(np.float32),
                dof_vel=rng.normal(size=(n, 28)).astype(np.float32),
                seq=rng.uniform(-0.9, 0.9, size=(2, 5, 28)).astype(np.float32))


@pytest.mark.parametrize("field", TOPOLOGY)
def test_topology_equal(models, field):
    jm, tm = models
    assert getattr(tm, field) == getattr(jm, field)


@pytest.mark.parametrize("field", TABLES)
def test_tables_equal(models, field):
    jm, tm = models
    got = getattr(tm, field).numpy()
    want = np.asarray(getattr(jm, field))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(got.dtype))


@pytest.mark.parametrize("geom", [
    jcm.GeomSpec("sphere", pos=(0, 0, 0.1), size=(0.09,), density=900.0),
    jcm.GeomSpec("box", pos=(0.04, 0, -0.02), size=(0.09, 0.05, 0.03),
                 quat=(0.0, 0.0, 0.3826834, 0.9238795)),
    jcm.GeomSpec("capsule", fromto=(0, 0, -0.04, 0.1, 0, -0.36),
                 size=(0.055,)),
    jcm.GeomSpec("capsule", fromto=(0, 0, 0, 1.0, 0.0, 0.0), size=(0.05,)),
], ids=["sphere", "box", "capsule", "capsule_x"])
def test_geom_mass_and_contact_points(geom):
    import dataclasses
    tgeom = tcm.GeomSpec(**dataclasses.asdict(geom))
    for want, got in zip(geom.mass_properties(), tgeom.mass_properties()):
        np.testing.assert_allclose(got, want, rtol=1e-12)
    for want, got in zip(geom.contact_points(), tgeom.contact_points()):
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_mesh_geom():
    rng = np.random.default_rng(3)
    verts = rng.normal(size=(40, 3))
    jg = jcm.GeomSpec("mesh", verts=verts)
    tg = tcm.GeomSpec("mesh", verts=verts)
    for want, got in zip(jg.mass_properties() + jg.contact_points(),
                         tg.mass_properties() + tg.contact_points()):
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_dof_maps(models, pose):
    jm, tm = models
    dof = pose["dof"]
    em = np.array(jit(lambda d: jcm.joint_exp_maps(jm, d))(dof))
    np.testing.assert_allclose(
        tcm.joint_exp_maps(tm, torch.as_tensor(dof)).numpy(), em, atol=1e-6)
    np.testing.assert_allclose(
        tcm.project_to_dof(tm, torch.as_tensor(em)).numpy(),
        np.asarray(jcm.project_to_dof(jm, jnp.asarray(em))), atol=1e-6)
    jr = np.array(jit(lambda d: jcm.dof_to_rot(jm, d))(dof))
    tr = tcm.dof_to_rot(tm, torch.as_tensor(dof))
    np.testing.assert_allclose(tr.numpy(), jr, atol=1e-5)
    np.testing.assert_allclose(
        tcm.rot_to_dof(tm, tr).numpy(),
        np.asarray(jit(lambda q: jcm.rot_to_dof(jm, q))(jr)), atol=1e-5)


def test_forward_kinematics_and_velocities(models, pose):
    jm, tm = models
    jr = np.array(jcm.dof_to_rot(jm, jnp.asarray(pose["dof"])))

    def jax_fn(rp, rr, q, rv, ra, dv):
        bp, br = jcm.forward_kinematics(jm, rp, rr, q)
        bv, ba = jcm.body_vel_from_dof_vel(jm, br, rv, ra, bp, dv)
        return bp, br, bv, ba

    args = (pose["root_pos"], pose["root_rot"], jr, pose["root_vel"],
            pose["root_ang_vel"], pose["dof_vel"])
    want = jit(jax_fn)(*args)
    t = [torch.as_tensor(a) for a in args]
    bp, br = tcm.forward_kinematics(tm, t[0], t[1], t[2])
    bv, ba = tcm.body_vel_from_dof_vel(tm, br, t[3], t[4], bp, t[5])
    for name, g, w in zip(("body_pos", "body_rot", "body_vel", "body_ang_vel"),
                          (bp, br, bv, ba), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   err_msg=name)


def test_frame_dof_vel(models, pose):
    jm, tm = models
    jr = np.array(jcm.dof_to_rot(jm, jnp.asarray(pose["seq"])))
    want = jit(lambda q: jcm.compute_frame_dof_vel(jm, q, 1.0 / 30))(jr)
    got = tcm.compute_frame_dof_vel(tm, torch.as_tensor(jr), 1.0 / 30)
    # finite differences scaled by fps = 30: 30x the rotation tolerance
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4)


def test_model_to_and_replace(models):
    _, tm = models
    assert tm.to("cpu") is tm
    passive = tm.replace(dof_stiffness=torch.zeros_like(tm.dof_stiffness))
    assert float(passive.dof_stiffness.abs().sum()) == 0.0
    assert passive.derived == {} and passive.num_bodies == tm.num_bodies
