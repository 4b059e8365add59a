"""Articulated rigid-body engine (PyTorch).

* Generalized coordinates + Featherstone ABA over the body tree, in world
  axes at per-body origins so transports are pure translations.
* Implicit stable-PD actuation: the PD drive's stiffness/damping enter the
  articulated-inertia diagonal, so kp=1000 joint drives stay stable at
  1/120 s.
* Direct heightfield contact: character contact points collide against
  the terrain grid (bilinear surface + analytic normals) with a
  regularized Coulomb penalty.
* Masked resets: resetting a subset of envs is a ``torch.where`` over the
  state (:func:`where_state`).

State layout: root state is (pos, quat, lin vel, ang vel) = 13-D; dof
state is (joint quats, dof vel); per-body net contact forces are kept for
the reward/done terms.

:func:`control_step` drives the control-step kernel (physics/substep.py):
the state is packed component-major once per control step, one launch
runs every substep's contact, PD, ABA, integration and FK, and the state
is unpacked once. On CPU tensors the same driver runs the kernel's plain
version.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from parc_torch import resolve_device
from parc_torch.anim import char_model as cm
from parc_torch.physics import spatial as sp
from parc_torch.utils import rotation as rot
from parc_torch.utils import terrain as terrain_lib
from parc_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Simulation parameters (60 Hz sim, 2 integrator substeps)."""

    dt: float = 1.0 / 60.0
    substeps: int = 2
    control_mode: str = "pd_implicit"
    # contact
    contact_stiffness: float = 8000.0
    contact_damping: float = 300.0
    friction: float = 1.0
    slip_vel: float = 0.1
    # per-point normal-force cap: bounds the energy a deep penetration can
    # inject
    max_contact_force: float = 3000.0
    # joint limits: hard by default, a stiff unilateral boundary spring
    # whose damping integrates implicitly through the ABA diagonal
    # (compute_joint_torques); hard_joint_limits=False uses the soft
    # penalty springs (limit_stiffness/damping)
    hard_joint_limits: bool = True
    hard_limit_stiffness: float = 5000.0
    hard_limit_damping: float = 50.0
    limit_stiffness: float = 200.0
    limit_damping: float = 5.0
    gravity: float = -9.81
    # torque limit scaling on the explicit PD term
    torque_limit_scale: float = 1.0


CONTROL_MODES = ("pd_implicit", "pd_exp", "pd_1d", "vel", "torque")


@dataclasses.dataclass
class SimState:
    """Batched simulator state; leading dims are environment dims."""

    root_pos: torch.Tensor      # (..., 3)
    root_rot: torch.Tensor      # (..., 4) xyzw
    root_vel: torch.Tensor      # (..., 3) world
    root_ang_vel: torch.Tensor  # (..., 3) world
    joint_rot: torch.Tensor     # (..., J-1, 4)
    dof_vel: torch.Tensor       # (..., D) local joint-frame rates
    # caches refreshed by refresh_kinematics
    body_pos: torch.Tensor      # (..., J, 3)
    body_rot: torch.Tensor      # (..., J, 4)
    body_vel: torch.Tensor      # (..., J, 3)
    body_ang_vel: torch.Tensor  # (..., J, 3)
    contact_forces: torch.Tensor  # (..., J, 3) net world contact force per body

    def replace(self, **changes) -> "SimState":
        return dataclasses.replace(self, **changes)


def create_state(model: cm.CharModel, root_pos, root_rot, joint_rot,
                 root_vel=None, root_ang_vel=None, dof_vel=None,
                 device="cuda") -> SimState:
    dev = resolve_device(device)
    model = model.to(dev)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    root_pos = t(root_pos)
    batch = root_pos.shape[:-1]

    def zeros(*shape):
        return torch.zeros(batch + shape, dtype=torch.float32, device=dev)

    state = SimState(
        root_pos=root_pos,
        root_rot=t(root_rot),
        root_vel=zeros(3) if root_vel is None else t(root_vel),
        root_ang_vel=zeros(3) if root_ang_vel is None else t(root_ang_vel),
        joint_rot=t(joint_rot),
        dof_vel=zeros(model.dof_size) if dof_vel is None else t(dof_vel),
        body_pos=zeros(model.num_bodies, 3),
        body_rot=zeros(model.num_bodies, 4),
        body_vel=zeros(model.num_bodies, 3),
        body_ang_vel=zeros(model.num_bodies, 3),
        contact_forces=zeros(model.num_bodies, 3),
    )
    return refresh_kinematics(model, state)


def refresh_kinematics(model: cm.CharModel, state: SimState) -> SimState:
    body_pos, body_rot = cm.forward_kinematics(
        model, state.root_pos, state.root_rot, state.joint_rot)
    body_vel, body_ang_vel = cm.body_vel_from_dof_vel(
        model, body_rot, state.root_vel, state.root_ang_vel, body_pos,
        state.dof_vel)
    return state.replace(body_pos=body_pos, body_rot=body_rot,
                         body_vel=body_vel, body_ang_vel=body_ang_vel)


# ---------------------------------------------------------------------------
# Contact
# ---------------------------------------------------------------------------


def _hf_height_and_normal(terrain: terrain_lib.Terrain, xy: torch.Tensor,
                          terrain_idx: Optional[torch.Tensor] = None):
    """Bilinear surface height and unit normal at world xy points.

    A stacked terrain (hf (M, H, W), min_point (M, 2)) is selected per env
    by ``terrain_idx`` (N,) with xy (N, P, 2): each env collides against
    its own motion's terrain.
    """
    batched = terrain.hf.ndim == 3
    min_point = (terrain.min_point[terrain_idx][..., None, :]
                 if batched else terrain.min_point)
    uv = (xy - min_point) / terrain.dxdy
    h_dim, w_dim = terrain.hf.shape[-2:]
    u = torch.clamp(uv[..., 0], 0.0, h_dim - 1)
    v = torch.clamp(uv[..., 1], 0.0, w_dim - 1)
    ix0 = torch.clamp(torch.floor(u).long(), max=h_dim - 2)
    iy0 = torch.clamp(torch.floor(v).long(), max=w_dim - 2)
    ix1, iy1 = ix0 + 1, iy0 + 1
    fx, fy = u - ix0.to(u.dtype), v - iy0.to(v.dtype)
    hf = terrain.hf
    if batched:
        t = terrain_idx[..., None]

        def take(ix, iy):
            return hf[t, ix, iy]
    else:
        def take(ix, iy):
            return hf[ix, iy]
    h00 = take(ix0, iy0)
    h10 = take(ix1, iy0)
    h01 = take(ix0, iy1)
    h11 = take(ix1, iy1)
    h = ((1 - fx) * (1 - fy) * h00 + fx * (1 - fy) * h10
         + (1 - fx) * fy * h01 + fx * fy * h11)
    dhdx = ((1 - fy) * (h10 - h00) + fy * (h11 - h01)) / terrain.dxdy[0]
    dhdy = ((1 - fx) * (h01 - h00) + fx * (h11 - h10)) / terrain.dxdy[1]
    n = torch.stack([-dhdx, -dhdy, torch.ones_like(h)], dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return h, n


def compute_contact_forces(model: cm.CharModel, params: SimParams,
                           terrain: terrain_lib.Terrain, state: SimState,
                           terrain_idx: Optional[torch.Tensor] = None):
    """Penalty contact of character points against the heightfield.

    Reads only the state's body arrays. Returns (f_ext (..., J, 6) spatial
    forces at body origins, net_force (..., J, 3) per-body world contact
    force).
    """
    bidx = model.contact_point_body  # (P,)
    offs = model.contact_point_offset  # (P, 3)
    rad = model.contact_point_radius  # (P,)

    bpos = state.body_pos[..., bidx, :]       # (..., P, 3)
    brot = state.body_rot[..., bidx, :]
    bvel = state.body_vel[..., bidx, :]
    bang = state.body_ang_vel[..., bidx, :]

    x = bpos + rot.quat_rotate(brot, offs.expand(bpos.shape))
    v = bvel + rot.cross(bang, x - bpos)

    h, n = _hf_height_and_normal(terrain, x[..., 0:2], terrain_idx)
    slope_cos = n[..., 2]
    phi = (x[..., 2] - rad - h) * slope_cos  # approx signed distance
    phi_dot = torch.sum(n * v, dim=-1)

    in_contact = phi < 0.0
    fn_mag = torch.clamp(
        -params.contact_stiffness * phi - params.contact_damping * phi_dot,
        min=0.0)
    fn_mag = torch.where(in_contact,
                         torch.clamp(fn_mag, max=params.max_contact_force),
                         torch.zeros_like(fn_mag))

    vt = v - n * phi_dot[..., None]
    vt_norm = torch.sqrt(torch.sum(vt * vt, dim=-1) + params.slip_vel**2 * 1e-4)
    # regularized Coulomb: full friction once |vt| >> slip_vel
    ft_scale = params.friction * fn_mag * torch.clamp(
        vt_norm / params.slip_vel, max=1.0)
    force = n * fn_mag[..., None] - vt / vt_norm[..., None] * ft_scale[..., None]

    # per-body sums of the point forces and their moments about the origin
    lead = force.shape[:-2]
    dim = force.ndim - 2
    net_force = torch.zeros(lead + (model.num_bodies, 3), dtype=force.dtype,
                            device=force.device).index_add_(dim, bidx, force)
    torque = rot.cross(x - bpos, force)
    net_torque = torch.zeros_like(net_force).index_add_(dim, bidx, torque)
    f_ext = torch.cat([net_torque, net_force], dim=-1)
    return f_ext, net_force


# ---------------------------------------------------------------------------
# PD actuation
# ---------------------------------------------------------------------------


def pd_errors(model: cm.CharModel, state: SimState,
              pd_target_dof: torch.Tensor,
              q_tar: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-dof position error to the PD target: exp-map of the relative
    rotation from current to target joint orientation, projected to dofs.
    ``q_tar`` is ``dof_to_rot(pd_target_dof)`` when the caller has it."""
    if q_tar is None:
        q_tar = cm.dof_to_rot(model, pd_target_dof)
    diff = rot.quat_mul(rot.quat_conjugate(state.joint_rot), q_tar)
    return cm.project_to_dof(model, rot.quat_to_exp_map(diff))


def dof_pos_from_state(model: cm.CharModel, state: SimState) -> torch.Tensor:
    return cm.rot_to_dof(model, state.joint_rot)


def compute_joint_torques(model: cm.CharModel, params: SimParams,
                          state: SimState, pd_target_dof: torch.Tensor,
                          dt: float, q_tar: Optional[torch.Tensor] = None):
    """Explicit torque + implicit per-dof diagonal for the ABA solve."""
    kp = model.dof_stiffness
    kd = model.dof_damping
    effort = model.dof_motor_effort * params.torque_limit_scale

    def clip(t):
        return torch.clamp(t, -effort, effort)

    mode = params.control_mode
    if mode == "torque":
        # direct torque actuation: pd_target_dof carries normalized torques
        tau = clip(pd_target_dof * effort)
        return tau, torch.zeros_like(tau)
    if mode == "vel":
        tau = clip(kd * (pd_target_dof - state.dof_vel))
        return tau, torch.zeros_like(tau)
    if mode == "pd_exp":
        err = pd_errors(model, state, pd_target_dof, q_tar)
        tau = clip(kp * err - kd * state.dof_vel)
        d_extra = torch.zeros_like(tau)
    elif mode == "pd_1d":
        # per-dof linear PD; only meaningful for 1D hinge characters where
        # dof space is linear
        err_1d = pd_target_dof - dof_pos_from_state(model, state)
        tau = clip(kp * err_1d - kd * state.dof_vel)
        d_extra = torch.zeros_like(tau)
    elif mode == "pd_implicit":  # stable PD
        err = pd_errors(model, state, pd_target_dof, q_tar)
        kd_eff = kd + dt * kp
        tau = clip(kp * err - kd_eff * state.dof_vel)
        d_extra = (dt * kd_eff).expand(tau.shape)
    else:
        raise ValueError(f"unknown control_mode {mode!r}; one of {CONTROL_MODES}")

    dof_pos = dof_pos_from_state(model, state)
    over = torch.clamp(dof_pos - model.dof_limits_upper, min=0.0)
    under = torch.clamp(model.dof_limits_lower - dof_pos, min=0.0)
    viol = (over > 0) | (under > 0)

    if params.hard_joint_limits:
        # stiff unilateral boundary spring whose damping (with the SPD-style
        # dt*K augmentation) integrates implicitly through the ABA diagonal
        d_eff = params.hard_limit_damping + dt * params.hard_limit_stiffness
        viol_f = viol.to(tau.dtype)
        tau_lim = (-params.hard_limit_stiffness * (over - under)
                   - d_eff * viol_f * state.dof_vel)
        return tau + tau_lim, d_extra + dt * d_eff * viol_f

    # joint-limit penalty springs
    tau_lim = (-params.limit_stiffness * (over - under)
               - params.limit_damping * torch.where(
                   viol, state.dof_vel, torch.zeros_like(state.dof_vel)))
    return tau + tau_lim, d_extra


# ---------------------------------------------------------------------------
# Featherstone ABA (world-axis, body-origin frames)
# ---------------------------------------------------------------------------


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., a, b) @ (..., b)."""
    return (m @ v[..., None])[..., 0]


def _inv3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / det
    adj = torch.stack([
        torch.stack([co_a, c * h - b * i, b * f - c * e], -1),
        torch.stack([co_b, a * i - c * g, c * d - a * f], -1),
        torch.stack([co_c, b * g - a * h, a * e - b * d], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def _solve6_sym(m: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Solve a batched symmetric 6x6 system via the 3x3 block Schur
    complement (closed form, no LU)."""
    a = m[..., 0:3, 0:3]
    b = m[..., 0:3, 3:6]
    d = m[..., 3:6, 3:6]
    r1 = r[..., 0:3]
    r2 = r[..., 3:6]
    a_inv = _inv3(a)
    bt_ainv = b.transpose(-1, -2) @ a_inv
    schur = d - bt_ainv @ b
    x2 = _mv(_inv3(schur), r2 - _mv(bt_ainv, r1))
    x1 = _mv(a_inv, r1 - _mv(b, x2))
    return torch.cat([x1, x2], dim=-1)


def aba(model: cm.CharModel, params: SimParams, state: SimState,
        tau: torch.Tensor, d_extra: torch.Tensor, f_ext: torch.Tensor):
    """Articulated-body forward dynamics, per-joint form.

    Args:
      tau: (..., D) explicit joint-space torques.
      d_extra: (..., D) implicit diagonal (SPD/damping) added to each
        joint's D matrix, pre-multiplied by dt.
      f_ext: (..., J, 6) external spatial forces at body origins.

    Returns:
      root_acc (..., 6) spatial (ang; lin) root acceleration, qdd (..., D).
    """
    nb = model.num_bodies
    batch = state.root_pos.shape[:-1]
    dtype, dev = state.root_pos.dtype, state.root_pos.device

    body_r = rot.quat_to_matrix(state.body_rot)  # (..., J, 3, 3)

    def r_of(j):
        return state.body_pos[..., j, :] - state.body_pos[..., model.parent_indices[j], :]

    # spatial velocity per body at its own origin (world axes)
    v = [sp.motion(state.root_ang_vel, state.root_vel)] + [None] * (nb - 1)
    s_mats = [None] * nb  # (..., 6, d) motion subspaces
    c_bias = [None] * nb
    for j in range(1, nb):
        jt = model.joint_types[j]
        o = model.dof_offsets[j]
        rj = body_r[..., j, :, :]
        v_p = sp.shift_motion(v[model.parent_indices[j]], r_of(j))
        if jt == cm.SPHERICAL:
            s = torch.cat([rj, torch.zeros_like(rj)], dim=-2)
            w_world = _mv(rj, state.dof_vel[..., o:o + 3])
        elif jt == cm.HINGE:
            axis_w = _mv(rj, model.joint_axes[j].expand(batch + (3,)))
            s = torch.cat([axis_w, torch.zeros_like(axis_w)], dim=-1)[..., None]
            w_world = axis_w * state.dof_vel[..., o:o + 1]
        else:  # FIXED
            s = None
            w_world = torch.zeros(batch + (3,), dtype=dtype, device=dev)
        vj = sp.motion(w_world, torch.zeros_like(w_world))
        v[j] = v_p + vj
        s_mats[j] = s
        c_bias[j] = sp.cross_motion(v[j], vj)

    # spatial inertia (world axes, at body origin) + velocity bias forces
    com_w = _mv(body_r, model.body_com)
    inertia_w = body_r @ model.body_inertia @ body_r.transpose(-1, -2)
    ia_all = sp.spatial_inertia(model.body_mass.expand(batch + (nb,)),
                                com_w, inertia_w)   # (..., J, 6, 6)
    ia = [ia_all[..., j, :, :] for j in range(nb)]
    pa = [sp.cross_force(v[j], _mv(ia[j], v[j])) - f_ext[..., j, :]
          for j in range(nb)]

    # inward pass
    u_list = [None] * nb
    d_inv = [None] * nb
    uu = [None] * nb
    for j in range(nb - 1, 0, -1):
        parent = model.parent_indices[j]
        o, end = model.joint_dof_slice(j)
        d = end - o
        r = r_of(j)
        if d == 0:
            ia[parent] = ia[parent] + sp.shift_inertia(ia[j], r)
            pa[parent] = pa[parent] + sp.shift_force(
                pa[j] + _mv(ia[j], c_bias[j]), r)
            continue
        s = s_mats[j]
        u = ia[j] @ s  # (..., 6, d)
        dmat = s.transpose(-1, -2) @ u  # (..., d, d)
        arm = model.dof_armature[o:end] + d_extra[..., o:end]
        dmat = dmat + arm[..., None] * torch.eye(d, dtype=dtype, device=dev)
        u_bias = tau[..., o:end] - _mv(s.transpose(-1, -2), pa[j])
        if d == 1:
            dinv = 1.0 / dmat[..., 0, 0]
            ud = u * dinv[..., None, None]
            corr = ud[..., 0] * u_bias
        else:
            dinv = _inv3(dmat)
            ud = u @ dinv
            corr = _mv(ud, u_bias)
        ia_art = ia[j] - ud @ u.transpose(-1, -2)
        pa_art = pa[j] + _mv(ia_art, c_bias[j]) + corr
        ia[parent] = ia[parent] + sp.shift_inertia(ia_art, r)
        pa[parent] = pa[parent] + sp.shift_force(pa_art, r)
        u_list[j] = u
        d_inv[j] = dinv
        uu[j] = u_bias

    # root solve: free joint, gravity as a fictitious base acceleration
    a_base = torch.zeros(batch + (6,), dtype=dtype, device=dev)
    a_base[..., 5] = -params.gravity
    rhs = -(pa[0] + _mv(ia[0], a_base))
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    root_acc = _solve6_sym(ia[0] + 1e-6 * eye6, rhs)

    # outward pass
    a = [a_base + root_acc] + [None] * (nb - 1)
    qdd = torch.zeros(batch + (model.dof_size,), dtype=dtype, device=dev)
    for j in range(1, nb):
        o, end = model.joint_dof_slice(j)
        a_p = sp.shift_motion(a[model.parent_indices[j]], r_of(j)) + c_bias[j]
        if end == o:
            a[j] = a_p
            continue
        ua = _mv(u_list[j].transpose(-1, -2), a_p)  # U^T a'
        if end - o == 1:
            qdd_j = d_inv[j][..., None] * (uu[j] - ua)
        else:
            qdd_j = _mv(d_inv[j], uu[j] - ua)
        qdd[..., o:end] = qdd_j
        a[j] = a_p + _mv(s_mats[j], qdd_j)

    return root_acc, qdd


# ---------------------------------------------------------------------------
# Integration + stepping
# ---------------------------------------------------------------------------


def integrate(model: cm.CharModel, state: SimState, root_acc: torch.Tensor,
              qdd: torch.Tensor, dt: float) -> SimState:
    """Semi-implicit Euler in generalized coordinates."""
    ang_new = state.root_ang_vel + dt * root_acc[..., 0:3]
    # spatial -> conventional acceleration of the root-origin particle
    lin_acc = root_acc[..., 3:6] + rot.cross(state.root_ang_vel, state.root_vel)
    vel_new = state.root_vel + dt * lin_acc
    dof_vel_new = state.dof_vel + dt * qdd

    root_pos = state.root_pos + dt * vel_new
    root_rot = rot.quat_normalize(
        rot.quat_mul(rot.exp_map_to_quat(ang_new * dt), state.root_rot))

    w_locals = cm.joint_exp_maps(model, dof_vel_new)  # (..., J-1, 3)
    dq = rot.exp_map_to_quat(w_locals * dt)
    joint_rot = rot.quat_normalize(rot.quat_mul(state.joint_rot, dq))

    state = state.replace(root_pos=root_pos, root_rot=root_rot,
                          root_vel=vel_new, root_ang_vel=ang_new,
                          joint_rot=joint_rot, dof_vel=dof_vel_new)
    return refresh_kinematics(model, state)


def control_step(model: cm.CharModel, params: SimParams,
                 terrain: terrain_lib.Terrain, state: SimState,
                 pd_target_dof: torch.Tensor, sim_steps: int = 2,
                 terrain_idx: Optional[torch.Tensor] = None,
                 step_fn=None) -> SimState:
    """One 30 Hz control step = ``sim_steps`` x 60 Hz sim steps of
    ``params.substeps`` substeps each, all holding the same PD target.

    The state is packed component-major once, one call of ``step_fn``
    runs every substep (contact, then PD + ABA + integrate + FK), and the
    state is unpacked once. ``contact_forces`` is the substep average of
    the last sim step. ``step_fn`` defaults to the kernel wrapper
    :func:`parc_torch.physics.substep.control_step_packed`; pass
    ``substep.control_step_packed_reference`` to run the plain version on
    any device.
    """
    from parc_torch.physics import substep as sub

    step = sub.control_step_packed if step_fn is None else step_fn
    with annotate("parc.physics.control_step"):
        lead = state.root_pos.shape[:-1]
        n = math.prod(lead)
        J = model.num_bodies
        flat_state = state if len(lead) == 1 else _reshape_state(state, (n,))
        act = pd_target_dof.expand(lead + (model.dof_size,)).reshape(n, -1)
        tidx = (None if terrain_idx is None
                else terrain_idx.expand(lead).reshape(n).to(torch.int32))

        if params.control_mode in ("pd_implicit", "pd_exp"):
            qtar = cm.dof_to_rot(model, act)
        else:
            qtar = torch.zeros((n, J - 1, 4), dtype=act.dtype,
                               device=act.device)
        state_p = sub.pack(sub.state_layout(model), vars(flat_state), n)
        const_p = sub.pack(sub.const_layout(model),
                           {"act": act, "qtar": qtar}, n)
        state_p, contact_p = step(model, params, terrain, state_p, const_p,
                                  tidx, sim_steps)
        out = sub.unpack_state(model, state_p, contact_p)
        return out if len(lead) == 1 else _reshape_state(out, lead)


def sim_step(model: cm.CharModel, params: SimParams,
             terrain: terrain_lib.Terrain, state: SimState,
             pd_target_dof: torch.Tensor,
             terrain_idx: Optional[torch.Tensor] = None) -> SimState:
    """One 60 Hz sim step: ``params.substeps`` substeps with torque and
    contact recomputed each substep."""
    return control_step(model, params, terrain, state, pd_target_dof,
                        sim_steps=1, terrain_idx=terrain_idx)


_TWO_DIM_FIELDS = ("joint_rot", "body_pos", "body_rot", "body_vel",
                   "body_ang_vel", "contact_forces")


def _reshape_state(state: SimState, lead) -> SimState:
    """Reshape the leading (env) dims of every field to ``lead``."""
    def re(name, x):
        k = 2 if name in _TWO_DIM_FIELDS else 1
        return x.reshape(tuple(lead) + x.shape[x.ndim - k:])
    return SimState(**{k: re(k, x) for k, x in vars(state).items()})


def where_state(mask: torch.Tensor, a: SimState, b: SimState) -> SimState:
    """Select per-env between two states (masked reset primitive)."""
    def sel(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))
        return torch.where(m, x, y)
    return SimState(**{k: sel(x, getattr(b, k)) for k, x in vars(a).items()})
