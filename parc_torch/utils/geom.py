"""Geometry utilities: OBB intersection tests and character surface
point sampling.

Reference parity: util/geom_util.py — separating-axis OBB-OBB test
(:333-565), point-vs-OBB (:199-332 adjacent helpers), and
get_char_point_samples (:788-931, the per-body surface point clouds used
by the MDM heightfield-collision loss and motion optimization).

The OBB tests are batched torch on the device of their inputs; the
surface samplers are host numpy, run once when a character is built.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from parc_torch.utils import rotation as rot


# ---------------------------------------------------------------------------
# Oriented bounding boxes (torch, batched)
# ---------------------------------------------------------------------------


def obb_obb_intersect(pos_a, dims_a, quat_a, pos_b, dims_b,
                      quat_b) -> torch.Tensor:
    """Separating-axis OBB-OBB intersection test (15 axes).

    pos: (..., 3) centers; dims: (..., 3) half-extents; quat: (..., 4).
    Returns (...,) bool — True when the boxes overlap.
    Reference: util/geom_util.py:333-565 (Real-Time Collision Detection
    ch. 4.4).
    """
    eps = 1e-5
    q_ab = rot.quat_normalize(
        rot.quat_mul(rot.quat_conjugate(quat_a), quat_b))
    r = rot.quat_to_matrix(q_ab)
    abs_r = torch.abs(r) + eps

    t = rot.quat_rotate_inverse(quat_a, pos_b - pos_a)

    separated = torch.zeros(t.shape[:-1], dtype=torch.bool, device=t.device)
    # A's face axes
    for i in range(3):
        ra = dims_a[..., i]
        rb = torch.sum(abs_r[..., i, :] * dims_b, dim=-1)
        separated |= (ra + rb) < torch.abs(t[..., i])
    # B's face axes
    for i in range(3):
        ra = torch.sum(abs_r[..., :, i] * dims_a, dim=-1)
        rb = dims_b[..., i]
        axis_len = torch.abs(torch.sum(r[..., :, i] * t, dim=-1))
        separated |= (ra + rb) < axis_len
    # 9 cross-product axes a_i x b_j
    for i in range(3):
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        for j in range(3):
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            ra = (dims_a[..., i1] * abs_r[..., i2, j]
                  + dims_a[..., i2] * abs_r[..., i1, j])
            rb = (dims_b[..., j1] * abs_r[..., i, j2]
                  + dims_b[..., j2] * abs_r[..., i, j1])
            axis_len = torch.abs(t[..., i2] * r[..., i1, j]
                                 - t[..., i1] * r[..., i2, j])
            separated |= (ra + rb) < axis_len
    return ~separated


def points_obb_sdf(points, pos, dims, quat) -> torch.Tensor:
    """SDF from points (..., N, 3) to one OBB per batch row."""
    local = rot.quat_rotate_inverse(
        quat[..., None, :].expand(points.shape[:-1] + (4,)),
        points - pos[..., None, :])
    d = torch.abs(local) - dims[..., None, :]
    outside = torch.linalg.norm(torch.clamp(d, min=0.0), dim=-1)
    inside = torch.clamp(torch.amax(d, dim=-1), max=0.0)
    return outside + inside


# ---------------------------------------------------------------------------
# Surface point samplers (host numpy; build-time)
# ---------------------------------------------------------------------------


def sphere_surface_points(radius: float,
                          num_subdivisions: int = 0) -> np.ndarray:
    """Octahedron-subdivision sphere sampling (reference:
    get_sphere_point_surface_samples)."""
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], np.float64)
    faces = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
             (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)]
    for _ in range(num_subdivisions):
        new_faces = []
        vlist = verts.tolist()
        for a, b, c in faces:
            def mid(i, j):
                m = (np.asarray(vlist[i]) + np.asarray(vlist[j])) / 2
                m /= np.linalg.norm(m)
                vlist.append(m.tolist())
                return len(vlist) - 1
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc),
                          (ab, bc, ca)]
        verts = np.asarray(vlist)
        faces = new_faces
    verts = np.unique(np.round(verts, 9), axis=0)
    return verts * radius


def box_surface_points(halfdims, num_slices: int = 2, dim_x: int = 3,
                       dim_y: int = 6) -> np.ndarray:
    """Grid samples over all 6 faces of a box (reference:
    get_box_point_surface_samples)."""
    hx, hy, hz = [float(h) for h in halfdims]
    xs = np.linspace(-hx, hx, dim_x)
    ys = np.linspace(-hy, hy, dim_y)
    zs = np.linspace(-hz, hz, num_slices + 2)
    pts = []
    for z in zs:
        edge_z = z in (zs[0], zs[-1])
        for x in xs:
            for y in ys:
                edge_xy = (x in (xs[0], xs[-1])) or (y in (ys[0], ys[-1]))
                if edge_z or edge_xy:
                    pts.append([x, y, z])
    return np.unique(np.asarray(pts, np.float64), axis=0)


def capsule_surface_points(a, b, radius: float,
                           num_circle_points: int = 4,
                           num_cylinder_slices: int = 4) -> np.ndarray:
    """Rings along the capsule axis plus the two cap poles (reference:
    capsule branch of get_char_point_samples)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    axis = b - a
    h = np.linalg.norm(axis)
    z = axis / h if h > 1e-9 else np.array([0.0, 0.0, 1.0])
    x = np.array([1.0, 0.0, 0.0])
    if abs(np.dot(x, z)) > 0.9:
        x = np.array([0.0, 1.0, 0.0])
    y = np.cross(z, x)
    y /= np.linalg.norm(y)
    x = np.cross(y, z)
    pts = [a - z * radius, b + z * radius]
    angles = np.linspace(0, 2 * np.pi, num_circle_points, endpoint=False)
    for t in np.linspace(0.0, 1.0, num_cylinder_slices):
        c = a + t * (b - a)
        for ang in angles:
            pts.append(c + radius * (np.cos(ang) * x + np.sin(ang) * y))
    return np.asarray(pts)


def char_surface_points(spec) -> Tuple[np.ndarray, np.ndarray]:
    """Dense per-body surface point cloud from a CharModelSpec's geoms
    (reference: geom_util.get_char_point_samples).

    Returns (body_idx (P,), offsets (P, 3)) in body-local frames.
    """
    body_idx: List[int] = []
    offsets: List[np.ndarray] = []
    for bi, body in enumerate(spec.bodies):
        for g in body.geoms:
            if g.kind == "sphere":
                pts = sphere_surface_points(g.size[0]) + np.asarray(g.pos)
            elif g.kind == "box":
                pts = box_surface_points(g.size[:3])
                q = np.asarray(g.quat, np.float64)
                if abs(q[3] - 1.0) > 1e-9:
                    qv, qw = q[:3], q[3]
                    t = 2.0 * np.cross(qv, pts)
                    pts = pts + qw * t + np.cross(qv, t)
                pts = pts + np.asarray(g.pos)
            elif g.kind == "capsule":
                pts = capsule_surface_points(g.fromto[:3], g.fromto[3:6],
                                             g.size[0])
            elif g.kind == "mesh":
                # subsample the vertex cloud (verts are already body-frame)
                v = np.asarray(g.verts, np.float64)
                step = max(len(v) // 64, 1)
                pts = v[::step]
            else:
                continue
            for p in pts:
                body_idx.append(bi)
                offsets.append(p)
    return (np.asarray(body_idx, np.int32),
            np.asarray(offsets, np.float64))
