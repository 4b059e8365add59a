"""The physics control-step kernel: its wrapper, its plain version, its layout.

One control step = ``sim_steps`` x ``params.substeps`` substeps, each =
heightfield contact -> PD torque (all control modes, hard or soft joint
limits) -> Featherstone ABA -> semi-implicit Euler -> FK with body
velocities, for every env, with the PD target held. The kernel
(csrc/control_step.cu, one launch per control step, a team of lanes per
env) replaces the TPU kernel
``parc_tpu/physics/pallas_substep.py::_substep_kernel`` and the contact
pass run between its launches (``parc_tpu/physics/engine.py``
``compute_contact_forces``).

Arrays are component-major (C, N) f32, so the kernel's loads of a row of
neighbouring envs are neighbouring addresses:

* state (292, N) for the humanoid, rows in :func:`state_layout` order;
* const (D + 4(J-1), N): the PD target / action and its joint quats;
* contact (3J, N): per-body net world contact force, the substep average
  of the last sim step.

Frozen plain copy for the benchmark's reference: only
:func:`control_step_packed_reference` (plain torch ops) and the layout; the
kernel's wrapper and library loader are left out.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from reference.anim import char_model as cm
from reference.physics import engine
from reference.utils import terrain as terrain_lib


# codes shared with csrc/substep_math.cuh
_JOINT_CODES = {cm.ROOT: 0, cm.HINGE: 1, cm.SPHERICAL: 2, cm.FIXED: 3}
_MODE_CODES = {m: i for i, m in enumerate(engine.CONTROL_MODES)}


class Layout:
    """Row layout of a packed (C, N) array: named fields, each a block of
    rows holding a (N,) + shape array."""

    def __init__(self, fields: Sequence[Tuple[str, Tuple[int, ...]]]):
        self.fields = list(fields)
        self.offsets: Dict[str, Tuple[int, int]] = {}
        self.shapes = dict(self.fields)
        off = 0
        for name, shape in self.fields:
            k = int(np.prod(shape))
            self.offsets[name] = (off, k)
            off += k
        self.total = off


def state_layout(model: cm.CharModel) -> Layout:
    J, D = model.num_bodies, model.dof_size
    return Layout([
        ("root_pos", (3,)), ("root_rot", (4,)), ("root_vel", (3,)),
        ("root_ang_vel", (3,)), ("joint_rot", (J - 1, 4)),
        ("dof_vel", (D,)), ("body_pos", (J, 3)), ("body_rot", (J, 4)),
        ("body_vel", (J, 3)), ("body_ang_vel", (J, 3)),
    ])


def const_layout(model: cm.CharModel) -> Layout:
    return Layout([("act", (model.dof_size,)),
                   ("qtar", (model.num_bodies - 1, 4))])


def pack(layout: Layout, arrays: dict, n: int) -> torch.Tensor:
    """dict of (n, ...) batch-major arrays -> contiguous (C, n)."""
    return torch.cat([arrays[name].reshape(n, -1).t()
                      for name, _ in layout.fields], dim=0).contiguous()


def unpack(packed: torch.Tensor, layout: Layout, name: str) -> torch.Tensor:
    """One field of a packed (C, n) array as an (n,) + shape view."""
    o, k = layout.offsets[name]
    return packed[o:o + k].t().reshape((packed.shape[1],) + layout.shapes[name])


def unpack_state(model: cm.CharModel, state_p: torch.Tensor,
                 contact_p: Optional[torch.Tensor] = None) -> engine.SimState:
    """A packed state (and packed contact forces) as a SimState of views."""
    lstate = state_layout(model)
    fields = {name: unpack(state_p, lstate, name) for name, _ in lstate.fields}
    contact = (torch.zeros_like(fields["body_pos"]) if contact_p is None
               else contact_p.t().reshape(fields["body_pos"].shape))
    return engine.SimState(contact_forces=contact, **fields)


def level_schedule(parents: Sequence[int]):
    """The tree passes' schedule of a body tree given by its parent indices
    (each parent listed before its children).

    Returns (level of each body, the bodies of each level, the children
    of each body highest index first: the order in which engine.aba's
    inward loop adds them to their parent)."""
    level: List[int] = []
    for j, p in enumerate(parents):
        if p >= j or (p < 0 and j > 0):
            raise ValueError(f"body {j} has parent {p}: the tree must list "
                             f"one root first and each parent before its "
                             f"children")
        level.append(0 if p < 0 else level[p] + 1)
    levels = [[j for j, lv in enumerate(level) if lv == k]
              for k in range(max(level) + 1)]
    children = [[c for c in range(len(parents) - 1, 0, -1)
                 if parents[c] == j] for j in range(len(parents))]
    return level, levels, children


def model_tables(model: cm.CharModel) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's packed model constants (int32, f32) on the model's
    device, built once per model and device (layout: substep_math.cuh)."""
    key = ("control_step_tables", str(model.device))
    if key not in model.derived:
        nb, nd = model.num_bodies, model.dof_size
        level, levels, children = level_schedule(model.parent_indices)
        point_body = model.contact_point_body.cpu().numpy().astype(np.int64)
        npt = point_body.shape[0]
        point_start = np.concatenate(
            [[0], np.cumsum(np.bincount(point_body, minlength=nb))])
        ints = np.concatenate([
            [nb, nd, npt, len(levels)], model.parent_indices,
            [_JOINT_CODES[t] for t in model.joint_types],
            model.dof_offsets, level,
            np.concatenate([[0], np.cumsum([len(c) for c in children])]),
            [c for ch in children for c in ch], point_body, point_start,
            np.argsort(point_body, kind="stable")]).astype(np.int32)

        def host(x):
            return x.detach().cpu().numpy().astype(np.float32).reshape(nb, -1)
        # unit hinge axes exactly as dof_map holds them
        dof_map = model.dof_map.cpu().numpy()
        axis_n = np.zeros((nb, 3), np.float32)
        for j in range(1, nb):
            if model.joint_types[j] == cm.HINGE:
                axis_n[j] = dof_map[j - 1, :, model.dof_offsets[j]]
        body = np.concatenate([
            host(model.local_translation), host(model.local_rotation),
            host(model.joint_axes), axis_n,
            host(model.body_mass), host(model.body_com),
            host(model.body_inertia)], axis=1)
        dofs = np.stack([
            t.detach().cpu().numpy() for t in (
                model.dof_stiffness, model.dof_damping,
                model.dof_motor_effort, model.dof_limits_lower,
                model.dof_limits_upper, model.dof_armature)])
        points = [model.contact_point_offset.cpu().numpy().ravel(),
                  model.contact_point_radius.cpu().numpy().ravel()]
        floats = np.concatenate([body.ravel(), dofs.ravel(), *points]
                                ).astype(np.float32)
        model.derived[key] = (torch.as_tensor(ints, device=model.device),
                              torch.as_tensor(floats, device=model.device))
    return model.derived[key]


def step_params(params: engine.SimParams, sim_steps: int):
    """The kernel's scalar arguments (f32 and int32 arrays, in the order
    parc::step_params of csrc/substep_math.cuh reads them)."""
    floats = np.asarray([
        params.dt / params.substeps, params.torque_limit_scale,
        params.hard_limit_stiffness, params.hard_limit_damping,
        params.limit_stiffness, params.limit_damping, params.gravity,
        params.contact_stiffness, params.contact_damping, params.friction,
        1.0 / params.slip_vel, params.slip_vel ** 2 * 1e-4,
        params.max_contact_force], np.float32)
    ints = np.asarray([_MODE_CODES[params.control_mode],
                       int(params.hard_joint_limits), sim_steps,
                       params.substeps], np.int32)
    return floats, ints


def stacked_terrain(terrain: terrain_lib.Terrain):
    """(hf (M, H, W), min_point (M, 2), dxdy (2,)): a single terrain as a
    stack of one."""
    if terrain.hf.ndim == 2:
        return terrain.hf[None], terrain.min_point[None], terrain.dxdy
    return terrain.hf, terrain.min_point, terrain.dxdy


def control_step_packed_reference(
        model: cm.CharModel, params: engine.SimParams,
        terrain: terrain_lib.Terrain, state_p: torch.Tensor,
        const_p: torch.Tensor, terrain_idx: Optional[torch.Tensor],
        sim_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version, same signature: every substep
    runs engine.compute_contact_forces on the packed body rows, then
    :func:`substep_reference`."""
    n = state_p.shape[1]
    J = model.num_bodies
    h = params.dt / params.substeps
    net_accum = None
    for _ in range(sim_steps):
        step_net = 0.0
        for _ in range(params.substeps):
            f_ext, net = engine.compute_contact_forces(
                model, params, terrain, unpack_state(model, state_p),
                terrain_idx)
            step_net = step_net + net
            fext_p = f_ext.reshape(n, 6 * J).t().contiguous()
            state_p = substep_reference(model, params, h, state_p, fext_p,
                                        const_p)
        net_accum = step_net / params.substeps
    return state_p, net_accum.reshape(n, 3 * J).t().contiguous()


def substep_reference(model: cm.CharModel, params: engine.SimParams,
                      h: float, state_p: torch.Tensor, fext_p: torch.Tensor,
                      const_p: torch.Tensor) -> torch.Tensor:
    """One substep in plain PyTorch on packed arrays (f_ext (6J, N): per
    body (moment; force) at its origin): unpack, run
    engine.compute_joint_torques, engine.aba and engine.integrate (which
    refreshes the kinematics), repack."""
    lconst = const_layout(model)
    n = state_p.shape[1]
    state = unpack_state(model, state_p)
    act = unpack(const_p, lconst, "act")
    qtar = unpack(const_p, lconst, "qtar")
    f_ext = fext_p.t().reshape(n, model.num_bodies, 6)
    tau, d_extra = engine.compute_joint_torques(model, params, state, act, h,
                                                q_tar=qtar)
    root_acc, qdd = engine.aba(model, params, state, tau, d_extra, f_ext)
    state = engine.integrate(model, state, root_acc, qdd, h)
    return pack(state_layout(model), vars(state), n)
