"""The control-step kernel's per-env math (csrc/substep_math.cuh), built
for the host with g++, against its plain PyTorch version.

The header is __host__ __device__ and guards those qualifiers outside
nvcc, so a tiny C driver that runs ``parc::control_step_host`` (each env's
column through a team of width 1, which walks every body in turn through
the same level-by-level code the card runs with a lane per body) runs the
kernel's arithmetic here, on the CPU. It is held against
``control_step_packed_reference`` for every control mode and both
joint-limit forms, on motion-lib states lowered into a bumpy stacked
terrain (contact active), with noisy velocities and some envs past their
joint limits; and on the quadruped (13 bodies, 12 hinge dofs: another
level schedule and set of contact points) in the control modes it runs in,
pd_implicit and pd_1d. Tolerances: the state at 2e-4 (the control-step tolerance of
tests/test_pallas.py:190-193); the contact forces at 2e-3 N + rtol 1e-5
(tests/test_torch_engine.py: the 8000 N/m contact stiffness times one f32
ulp of a contact point's height). The __global__ kernel in
csrc/control_step.cu runs only on the card (chip_smoke.py, and the
cuda-marked tests below).
"""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from parc_torch import cuda_build
from parc_torch.anim import char_model as cm
from parc_torch.anim import motion_lib as ml
from parc_torch.data.humanoid import humanoid_spec
from parc_torch.data.quadruped import quadruped_spec, standing_pose_dof
from parc_torch.data.synthetic import standing_clip, walking_clip
from parc_torch.physics import engine
from parc_torch.physics import substep as sub
from parc_torch.utils import terrain as tl

torch.set_num_threads(1)

N = 16
H = 1.0 / 120.0

DRIVER = r"""
#include "substep_math.cuh"
extern "C" void run_control_step(const float* state, const float* cnst,
                                 float* out, float* contact, int n,
                                 const int* itab, const float* ftab,
                                 const float* hf, const float* min_point,
                                 const float* dxdy, int m, int h, int w,
                                 const int* tidx, const float* fp,
                                 const int* ip) {
  const parc::Terrain ter{hf, min_point, dxdy, m, h, w};
  parc::control_step_host(state, cnst, out, contact, n, itab, ftab, ter, tidx,
                          parc::step_params(fp, ip));
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the kernel math is built for the host "
                    "with g++")
    d = tmp_path_factory.mktemp("control_step_host")
    (d / "driver.cpp").write_text(DRIVER)
    so = d / "libcontrol_step_host.so"
    proc = subprocess.run(
        [gxx, "-O1", "-shared", "-fPIC", "-std=c++17", "-Wall", "-Werror",
         f"-I{cuda_build.CSRC}", str(d / "driver.cpp"), "-o", str(so)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    lib.run_control_step.restype = None
    lib.run_control_step.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
    return lib


def host_control_step(lib, model, params, terrain, state_p, const_p, tidx,
                      sim_steps):
    """The host build's control step, with control_step_packed's
    signature."""
    itab, ftab = sub.model_tables(model)
    hf, min_point, dxdy = (t.contiguous()
                           for t in sub.stacked_terrain(terrain))
    fp, ip = sub.step_params(params, sim_steps)
    n = state_p.shape[1]
    out = torch.empty_like(state_p)
    contact = torch.empty(3 * model.num_bodies, n)
    lib.run_control_step(
        state_p.data_ptr(), const_p.data_ptr(), out.data_ptr(),
        contact.data_ptr(), n, itab.data_ptr(), ftab.data_ptr(),
        hf.data_ptr(), min_point.data_ptr(), dxdy.data_ptr(), *hf.shape,
        tidx.data_ptr(), fp.ctypes.data, ip.ctypes.data)
    return out, contact


def bumpy_terrains(rng, device="cpu"):
    """Two stacked 16 x 16 heightfields, 0.4 m cells, bumps of up to 8 cm
    around the origin."""
    return tl.stack_terrains([
        tl.Terrain(hf=torch.as_tensor(
                       rng.uniform(0.0, 0.08, (16, 16)).astype(np.float32),
                       device=device),
                   hf_mask=None, hf_maxmin=None,
                   min_point=torch.tensor(mp, device=device),
                   dxdy=torch.tensor([0.4, 0.4], device=device))
        for mp in ([-3.2, -3.2], [-3.0, -2.8])])


@pytest.fixture(scope="module")
def inputs():
    """N envs: motion-lib frames lowered 0-6 cm into a bumpy stacked
    terrain (each env on one of two), noisy dof velocities, every second
    env past its joint limits, PD targets near the pose."""
    model = humanoid_spec().build(device="cpu")
    lib = ml.build_motion_lib(model, [standing_clip(), walking_clip(seed=1)],
                              device="cpu")
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, 2, N))
    times = torch.as_tensor(rng.uniform(0, 2.5, N), dtype=torch.float32)
    fr = ml.calc_motion_frame(lib, ids, times)
    dof = cm.rot_to_dof(model, fr.joint_rot)
    push = torch.as_tensor(rng.uniform(0.05, 0.3, (N, model.dof_size)),
                           dtype=torch.float32)
    row = torch.arange(N)[:, None]
    dof = torch.where(row % 4 == 1, model.dof_limits_upper + push,
                      torch.where(row % 4 == 3, model.dof_limits_lower - push,
                                  dof))
    dof_vel = fr.dof_vel + torch.as_tensor(
        rng.normal(0, 1.0, (N, model.dof_size)), dtype=torch.float32)
    root_pos = fr.root_pos.clone()
    root_pos[:, :2] = torch.as_tensor(rng.uniform(-1.5, 1.5, (N, 2)),
                                      dtype=torch.float32)
    root_pos[:, 2] -= torch.as_tensor(rng.uniform(0.0, 0.06, N),
                                      dtype=torch.float32)
    st = engine.create_state(model, root_pos, fr.root_rot,
                             cm.dof_to_rot(model, dof), fr.root_vel,
                             fr.root_ang_vel, dof_vel, device="cpu")
    act = (cm.rot_to_dof(model, fr.joint_rot) + torch.as_tensor(
        rng.normal(0, 0.1, (N, model.dof_size)), dtype=torch.float32))
    terrain = bumpy_terrains(rng)
    tidx = torch.as_tensor(rng.integers(0, 2, N), dtype=torch.int32)
    state_p = sub.pack(sub.state_layout(model), vars(st), N)
    return model, terrain, state_p, act, tidx


def _const(model, mode, act):
    n = act.shape[0]
    qtar = (cm.dof_to_rot(model, act) if mode in ("pd_implicit", "pd_exp")
            else torch.zeros(n, model.num_bodies - 1, 4, device=act.device))
    return sub.pack(sub.const_layout(model), {"act": act, "qtar": qtar}, n)


def _assert_step_close(model, got, want):
    (gs, gc), (ws, wc) = got, want
    assert torch.isfinite(gs).all() and torch.isfinite(gc).all()
    layout = sub.state_layout(model)
    for name, _ in layout.fields:
        np.testing.assert_allclose(sub.unpack(gs, layout, name).cpu().numpy(),
                                   sub.unpack(ws, layout, name).cpu().numpy(),
                                   atol=2e-4, rtol=0, err_msg=name)
    assert float(wc.abs().max()) > 50.0  # contact is active
    np.testing.assert_allclose(gc.cpu().numpy(), wc.cpu().numpy(), atol=2e-3,
                               rtol=1e-5, err_msg="contact_forces")


@pytest.mark.parametrize("hard", [True, False], ids=["hard", "soft"])
@pytest.mark.parametrize("mode", engine.CONTROL_MODES)
def test_kernel_math_matches_plain(host_lib, inputs, mode, hard):
    """Contact + one substep (one sim step of one substep)."""
    model, terrain, state_p, act, tidx = inputs
    params = engine.SimParams(control_mode=mode, hard_joint_limits=hard,
                              dt=H, substeps=1)
    args = (model, params, terrain, state_p, _const(model, mode, act), tidx, 1)
    _assert_step_close(model, host_control_step(host_lib, *args),
                       sub.control_step_packed_reference(*args))


def test_kernel_math_control_step(host_lib, inputs):
    """A whole control step: 2 sim steps x 2 substeps, pd_implicit."""
    model, terrain, state_p, act, tidx = inputs
    args = (model, engine.SimParams(), terrain, state_p,
            _const(model, "pd_implicit", act), tidx, 2)
    _assert_step_close(model, host_control_step(host_lib, *args),
                       sub.control_step_packed_reference(*args))


def test_level_schedule(inputs):
    """The humanoid's five levels, and each body's children in the order
    engine.aba's inward loop adds them (highest index first), as the
    packed table holds them."""
    model = inputs[0]
    level, levels, children = sub.level_schedule(model.parent_indices)
    assert levels == [[0], [1, 9, 12], [2, 3, 6, 10, 13], [4, 7, 11, 14],
                      [5, 8]]
    assert children[0] == [12, 9, 1] and children[1] == [6, 3, 2]
    assert children[5] == [] and children[3] == [4]
    nb = model.num_bodies
    itab = sub.model_tables(model)[0].tolist()
    assert itab[3] == 5  # levels
    assert itab[4 + 3 * nb:4 + 4 * nb] == level
    start = itab[4 + 4 * nb:4 + 5 * nb + 1]
    child = itab[4 + 5 * nb + 1:4 + 6 * nb]
    assert [child[start[j]:start[j + 1]] for j in range(nb)] == children
    with pytest.raises(ValueError):
        sub.level_schedule([-1, 2, 0])  # a parent listed after its child


def test_model_tables_layout(inputs):
    model = inputs[0]
    itab, ftab = sub.model_tables(model)
    nb, nd = model.num_bodies, model.dof_size
    npt = model.contact_point_body.shape[0]
    assert itab.dtype == torch.int32 and ftab.dtype == torch.float32
    ints = itab.tolist()
    assert ints[:4] == [nb, nd, npt, 5]
    assert ints[4:4 + nb] == list(model.parent_indices)
    assert itab.numel() == 4 + 7 * nb + 1 + 2 * npt
    assert ftab.numel() == 26 * nb + 6 * nd + 4 * npt
    # contact tables: each point's body, each body's points in point order
    body = model.contact_point_body.tolist()
    base = 4 + 6 * nb  # past child_start (nb + 1) and child (nb - 1)
    assert ints[base:base + npt] == body
    start = ints[base + npt:base + npt + nb + 1]
    point = ints[base + npt + nb + 1:]
    assert len(point) == npt and start[-1] == npt
    for j in range(nb):
        assert point[start[j]:start[j + 1]] == [p for p in range(npt)
                                                if body[p] == j]
    floats = ftab[26 * nb + 6 * nd:]
    assert torch.equal(floats[:3 * npt],
                       model.contact_point_offset.reshape(-1))
    assert torch.equal(floats[3 * npt:], model.contact_point_radius.reshape(-1))
    assert sub.model_tables(model)[1] is ftab  # packed once per model


# contact parameters scaled to the ~11 kg quadruped (tests/test_physics.py:
# 246-249)
ROBOT = dict(contact_stiffness=2500.0, contact_damping=100.0,
             max_contact_force=400.0)


@pytest.fixture(scope="module")
def quad_inputs():
    """N quadrupeds near the standing pose (seeded noise on the joints,
    every second env's knees past their upper limit), their feet in the
    bumpy stacked terrain, noisy velocities, PD targets near the stand."""
    model = quadruped_spec().build(device="cpu")
    rng = np.random.default_rng(1)
    stand = torch.as_tensor(standing_pose_dof())

    def noise(scale, *shape):
        return torch.as_tensor(rng.normal(0, scale, shape),
                               dtype=torch.float32)
    dof = stand + noise(0.15, N, 12)
    push = torch.as_tensor(rng.uniform(0.05, 0.3, (N, 12)),
                           dtype=torch.float32)
    knee = (torch.arange(N)[:, None] % 2 == 1) & (torch.arange(12) % 3 == 2)
    dof = torch.where(knee, model.dof_limits_upper + push, dof)
    root_rot = noise(0.05, N, 4)
    root_rot[:, 3] = 1.0
    root_rot = root_rot / root_rot.norm(dim=-1, keepdim=True)
    root_pos = torch.zeros(N, 3)
    root_pos[:, :2] = torch.as_tensor(rng.uniform(-1.5, 1.5, (N, 2)))
    root_pos[:, 2] = torch.as_tensor(rng.uniform(0.26, 0.3, N))
    st = engine.create_state(model, root_pos, root_rot,
                             cm.dof_to_rot(model, dof), noise(0.3, N, 3),
                             noise(0.3, N, 3), noise(1.0, N, 12),
                             device="cpu")
    act = stand + noise(0.1, N, 12)
    terrain = bumpy_terrains(rng)
    tidx = torch.as_tensor(rng.integers(0, 2, N), dtype=torch.int32)
    state_p = sub.pack(sub.state_layout(model), vars(st), N)
    return model, terrain, state_p, act, tidx


def test_quadruped_tables(quad_inputs):
    """The quadruped's level schedule (a trunk with four 3-deep legs) and
    its packed table's sizes."""
    model = quad_inputs[0]
    level, levels, children = sub.level_schedule(model.parent_indices)
    assert levels == [[0], [1, 4, 7, 10], [2, 5, 8, 11], [3, 6, 9, 12]]
    assert children[0] == [10, 7, 4, 1] and children[3] == []
    itab, ftab = sub.model_tables(model)
    nb, nd = model.num_bodies, model.dof_size
    npt = model.contact_point_body.shape[0]
    assert (nb, nd, npt) == (13, 12, 36)
    assert itab.tolist()[:4] == [nb, nd, npt, 4]
    assert itab.numel() == 4 + 7 * nb + 1 + 2 * npt
    assert ftab.numel() == 26 * nb + 6 * nd + 4 * npt


@pytest.mark.parametrize("mode", ["pd_implicit", "pd_1d"])
def test_kernel_math_quadruped(host_lib, quad_inputs, mode):
    """A whole control step (2 sim steps x 2 substeps) of the quadruped,
    with the ~11 kg robot's contact parameters."""
    model, terrain, state_p, act, tidx = quad_inputs
    args = (model, engine.SimParams(control_mode=mode, **ROBOT), terrain,
            state_p, _const(model, mode, act), tidx, 2)
    _assert_step_close(model, host_control_step(host_lib, *args),
                       sub.control_step_packed_reference(*args))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [N, 3], ids=["full", "tail"])
@pytest.mark.parametrize("mode", engine.CONTROL_MODES)
def test_cuda_kernel_matches_plain(cuda, inputs, mode, n):
    """Contact + one substep on the card against the plain version, one
    launch per call, and two launches on the same input give the same
    bits. At n = 3 the envs fill part of one block, so the kernel's tail
    code (repeated last env, no contact write-back past n) runs."""
    model, terrain, state_p, act, tidx = inputs
    model = model.to(cuda)
    terrain = dataclasses.replace(
        terrain, hf=terrain.hf.to(cuda), min_point=terrain.min_point.to(cuda),
        dxdy=terrain.dxdy.to(cuda))
    args = (model, engine.SimParams(control_mode=mode, dt=H, substeps=1),
            terrain, state_p[:, :n].contiguous().to(cuda),
            _const(model, mode, act[:n].to(cuda)),
            tidx[:n].contiguous().to(cuda), 1)
    before = sub.control_step_packed.launches
    got = sub.control_step_packed(*args)
    again = sub.control_step_packed(*args)
    torch.cuda.synchronize()
    assert sub.control_step_packed.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _assert_step_close(model, got, sub.control_step_packed_reference(*args))
