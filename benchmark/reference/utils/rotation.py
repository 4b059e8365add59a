"""Quaternion / exp-map / rotation algebra (PyTorch).

Conventions:

* Quaternions are stored ``(x, y, z, w)``.
* Exponential maps are ``axis * angle`` 3-vectors.
* ``calc_heading`` is the yaw of the rotated x-axis.
* ``quat_diff(q0, q1) = q1 * q0^-1`` is the WORLD-frame rotation taking
  q0 to q1.

Every function broadcasts over arbitrary leading batch dimensions. Norms
are guarded so gradients at the identity stay finite.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product of the last axis, broadcasting the leading dims."""
    return torch.linalg.cross(a, b, dim=-1)


def _unit(shape_like: torch.Tensor, axis: int) -> torch.Tensor:
    """A (..., 3) unit vector along ``axis`` shaped like ``shape_like``."""
    out = torch.zeros_like(shape_like)
    out[..., axis] = 1.0
    return out


def normalize_angle(x: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi]."""
    return torch.atan2(torch.sin(x), torch.cos(x))


def normalize(x: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """Normalize the last axis, guarding against zero vectors."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps)


def _safe_norm(x: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """Norm of the last axis with non-NaN gradient at 0."""
    sq = torch.sum(x * x, dim=-1)
    return torch.sqrt(torch.clamp(sq, min=eps * eps))


def normalize_exp_map(exp_map: torch.Tensor) -> torch.Tensor:
    """Re-wrap an exp-map so its angle lies in (-pi, pi]."""
    angle = _safe_norm(exp_map)
    scale = normalize_angle(angle) / angle
    return exp_map * scale[..., None]


def quat_unit(q: torch.Tensor) -> torch.Tensor:
    return normalize(q)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_pos(q: torch.Tensor) -> torch.Tensor:
    """Flip quaternion sign so that w >= 0."""
    return torch.where(q[..., 3:4] < 0, -q, q)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion with positive w."""
    return quat_unit(quat_pos(q))


def quat_abs(q: torch.Tensor) -> torch.Tensor:
    return _safe_norm(q)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, xyzw layout."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    x = aw * bx + ax * bw + ay * bz - az * by
    y = aw * by - ax * bz + ay * bw + az * bx
    z = aw * bz + ax * by - ay * bx + az * bw
    w = aw * bw - ax * bx - ay * by - az * bz
    return torch.stack([x, y, z, w], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q."""
    q_v = q[..., :3]
    q_w = q[..., 3:4]
    t = 2.0 * cross(q_v, v)
    return v + q_w * t + cross(q_v, t)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conjugate(q), v)


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    return quat_conjugate(quat_normalize(q))


def quat_diff(q0: torch.Tensor, q1: torch.Tensor) -> torch.Tensor:
    """q1 * q0^-1: the WORLD-frame rotation taking q0 to q1."""
    return quat_mul(q1, quat_conjugate(q0))


def quat_diff_angle(q0: torch.Tensor, q1: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between two rotations (always >= 0)."""
    dq = quat_normalize(quat_diff(q0, q1))
    im = _safe_norm(dq[..., :3])
    re = torch.abs(dq[..., 3])
    return 2.0 * torch.atan2(im, re)


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    theta = (angle / 2.0)[..., None]
    xyz = normalize(axis) * torch.sin(theta)
    w = torch.cos(theta)
    return quat_unit(torch.cat([xyz, w], dim=-1))


def quat_to_axis_angle(q: torch.Tensor, eps: float = 1e-5):
    """Return (axis, angle) with angle >= 0 and default z-axis at identity."""
    q = quat_pos(q)
    length = _safe_norm(q[..., 0:3])
    angle = 2.0 * torch.atan2(length, q[..., 3])
    axis = q[..., 0:3] / length[..., None]
    mask = length > eps
    angle = torch.where(mask, angle, torch.zeros_like(angle))
    axis = torch.where(mask[..., None], axis, _unit(axis, 2))
    return axis, angle


def quat_to_exp_map(q: torch.Tensor) -> torch.Tensor:
    axis, angle = quat_to_axis_angle(q)
    return axis * angle[..., None]


def axis_angle_to_exp_map(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    return axis * angle[..., None]


def exp_map_to_axis_angle(exp_map: torch.Tensor, eps: float = 1e-5):
    angle = _safe_norm(exp_map)
    axis = exp_map / angle[..., None]
    mask = angle > eps
    out_angle = torch.where(mask, angle, torch.zeros_like(angle))
    out_axis = torch.where(mask[..., None], axis, _unit(axis, 2))
    return out_axis, out_angle


def exp_map_to_quat(exp_map: torch.Tensor) -> torch.Tensor:
    axis, angle = exp_map_to_axis_angle(exp_map)
    return axis_angle_to_quat(axis, angle)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    i, j, k, w = q.unbind(-1)
    two_s = 2.0 / torch.sum(q * q, dim=-1)
    m = torch.stack([
        1 - two_s * (j * j + k * k),
        two_s * (i * j - k * w),
        two_s * (i * k + j * w),
        two_s * (i * j + k * w),
        1 - two_s * (i * i + k * k),
        two_s * (j * k - i * w),
        two_s * (i * k - j * w),
        two_s * (j * k + i * w),
        1 - two_s * (i * i + j * j),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (xyzw), branchless Shepperd's method."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    def _sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    tr = m00 + m11 + m22
    qw0 = _sqrt(1.0 + tr) / 2.0
    q0 = torch.stack([(m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0), qw0], dim=-1)
    qx1 = _sqrt(1.0 + m00 - m11 - m22) / 2.0
    q1 = torch.stack([qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1),
                      (m21 - m12) / (4 * qx1)], dim=-1)
    qy2 = _sqrt(1.0 - m00 + m11 - m22) / 2.0
    q2 = torch.stack([(m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2),
                      (m02 - m20) / (4 * qy2)], dim=-1)
    qz3 = _sqrt(1.0 - m00 - m11 + m22) / 2.0
    q3 = torch.stack([(m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3,
                      (m10 - m01) / (4 * qz3)], dim=-1)

    # pick the numerically best branch
    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q_neg = torch.where(cond1[..., None], q1,
                        torch.where(cond2[..., None], q2, q3))
    q = torch.where((tr > 0.0)[..., None], q0, q_neg)
    return quat_normalize(q)


def matrix_to_exp_map(m: torch.Tensor) -> torch.Tensor:
    return quat_to_exp_map(matrix_to_quat(m))


def quat_to_tan_norm(q: torch.Tensor) -> torch.Tensor:
    """6D rotation feature: rotated x (tangent) and z (normal) axes."""
    ref = q[..., 0:3]
    tan = quat_rotate(q, _unit(ref, 0))
    norm = quat_rotate(q, _unit(ref, 2))
    return torch.cat([tan, norm], dim=-1)


def tan_norm_to_matrix(tan_norm: torch.Tensor) -> torch.Tensor:
    tan = normalize(tan_norm[..., 0:3])
    norm = tan_norm[..., 3:6]
    norm = normalize(norm - torch.sum(tan * norm, dim=-1, keepdim=True) * tan)
    binorm = cross(norm, tan)
    return torch.stack([tan, binorm, norm], dim=-1)


def tan_norm_to_quat(tan_norm: torch.Tensor) -> torch.Tensor:
    return matrix_to_quat(tan_norm_to_matrix(tan_norm))


def slerp(q0: torch.Tensor, q1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation; t broadcasts against batch dims of q0/q1."""
    cos_half = torch.sum(q0 * q1, dim=-1)
    q1 = torch.where((cos_half < 0)[..., None], -q1, q1)
    cos_half = torch.abs(cos_half)[..., None]
    cos_half_c = torch.clamp(cos_half, -1.0, 1.0)
    half_theta = torch.arccos(cos_half_c)
    sin_half = torch.sqrt(torch.clamp(1.0 - cos_half_c * cos_half_c, min=1e-12))

    if t.ndim == q0.ndim - 1:
        t = t[..., None]
    ratio_a = torch.sin((1.0 - t) * half_theta) / sin_half
    ratio_b = torch.sin(t * half_theta) / sin_half
    out = ratio_a * q0 + ratio_b * q1
    out = torch.where(torch.abs(sin_half) < 1e-3, 0.5 * q0 + 0.5 * q1, out)
    out = torch.where(cos_half >= 1.0, q0, out)
    return out


def calc_heading(q: torch.Tensor) -> torch.Tensor:
    """Yaw of the rotated x axis."""
    rot_dir = quat_rotate(q, _unit(q[..., 0:3], 0))
    return torch.atan2(rot_dir[..., 1], rot_dir[..., 0])


def heading_to_quat(heading: torch.Tensor) -> torch.Tensor:
    axis = torch.zeros(heading.shape + (3,), dtype=heading.dtype,
                       device=heading.device)
    axis[..., 2] = 1.0
    return axis_angle_to_quat(axis, heading)


def calc_heading_quat(q: torch.Tensor) -> torch.Tensor:
    return heading_to_quat(calc_heading(q))


def calc_heading_quat_inv(q: torch.Tensor) -> torch.Tensor:
    return heading_to_quat(-calc_heading(q))


def quat_from_euler_xyz(roll: torch.Tensor, pitch: torch.Tensor,
                        yaw: torch.Tensor) -> torch.Tensor:
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    qw = cy * cr * cp + sy * sr * sp
    qx = cy * sr * cp - sy * cr * sp
    qy = cy * cr * sp + sy * sr * cp
    qz = sy * cr * cp - cy * sr * sp
    return torch.stack([qx, qy, qz, qw], dim=-1)


def euler_xyz_to_exp_map(roll: torch.Tensor, pitch: torch.Tensor,
                         yaw: torch.Tensor) -> torch.Tensor:
    return quat_to_exp_map(quat_from_euler_xyz(roll, pitch, yaw))


def quat_integrate_angular_velocity(ang_vel: torch.Tensor, q: torch.Tensor,
                                    dt) -> torch.Tensor:
    """q(t+dt) from world-frame angular velocity (first-order exp)."""
    dq = exp_map_to_quat(ang_vel * dt)
    return quat_normalize(quat_mul(dq, q))


def quat_differentiate_angular_velocity(q_next: torch.Tensor,
                                        q_curr: torch.Tensor,
                                        dt) -> torch.Tensor:
    """World-frame angular velocity taking q_curr to q_next over dt."""
    dq = quat_normalize(quat_mul(q_next, quat_conjugate(q_curr)))
    return quat_to_exp_map(dq) / dt


def rotate_2d_vec(vec: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    x = c * vec[..., 0] - s * vec[..., 1]
    y = s * vec[..., 0] + c * vec[..., 1]
    return torch.stack([x, y], dim=-1)


def heading_angle_from_xy(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.atan2(y, x)


def quat_diff_vec(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """Shortest-arc quaternion rotating v0 onto v1."""
    v0 = normalize(v0)
    v1 = normalize(v1)
    xyz = cross(v0, v1)
    w = 1.0 + torch.sum(v0 * v1, dim=-1, keepdim=True)
    q = torch.cat([xyz, w], dim=-1)
    # antiparallel fallback: rotate pi about any perpendicular axis
    perp = cross(v0, _unit(v0, 2))
    perp = torch.where(_safe_norm(perp)[..., None] < 1e-6,
                       cross(v0, _unit(v0, 1)), perp)
    anti = torch.cat([normalize(perp), torch.zeros_like(w)], dim=-1)
    q = torch.where(w < 1e-6, anti, q)
    return quat_unit(q)


def rotate_quat_by_heading(heading: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return quat_mul(heading_to_quat(heading), q)


def rotate_exp_map_by_heading(heading: torch.Tensor,
                              exp_map: torch.Tensor) -> torch.Tensor:
    return quat_to_exp_map(rotate_quat_by_heading(heading,
                                                  exp_map_to_quat(exp_map)))
