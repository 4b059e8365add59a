"""Kinematic character model: host-side spec + device tables (PyTorch).

Joint conventions:
* joint types: ROOT (6-DoF free), HINGE (1 DoF about a fixed axis),
  SPHERICAL (3-DoF exp-map), FIXED (0 DoF).
* FK composes ``world_rot = parent_rot * local_rot * joint_rot`` and
  ``world_pos = parent_pos + rotate(parent_rot, local_translation)``.
* dof velocities are log-map finite differences of relative joint
  rotations.
"""

from __future__ import annotations

import dataclasses
import math
import os
import struct as _struct
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from reference import resolve_device
from reference.utils import rotation as rot

# ---------------------------------------------------------------------------
# Host-side specification (plain python; declared in code)
# ---------------------------------------------------------------------------

ROOT, HINGE, SPHERICAL, FIXED = "root", "hinge", "spherical", "fixed"

_DOF_DIMS = {ROOT: 0, HINGE: 1, SPHERICAL: 3, FIXED: 0}


@dataclasses.dataclass
class GeomSpec:
    """Collision/visual geometry attached to a body.

    ``kind`` is one of sphere / capsule / box / mesh. Spheres and boxes use
    ``pos`` + ``size`` (sphere radius, or box half extents); capsules use
    ``fromto`` (segment endpoints in the body frame) + ``size`` (radius).
    Meshes carry their vertices (body frame); mass/inertia use the AABB box
    approximation and contact points a farthest-point vertex subset.
    """

    kind: str
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    size: Tuple[float, ...] = (0.1,)
    fromto: Optional[Tuple[float, ...]] = None
    density: float = 1000.0
    quat: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    verts: Optional[np.ndarray] = None    # (V, 3) mesh vertices, body frame

    def mass_properties(self):
        """Return (mass, com, inertia_about_com) in the body frame."""
        if self.kind == "sphere":
            r = self.size[0]
            m = self.density * 4.0 / 3.0 * math.pi * r**3
            i = 2.0 / 5.0 * m * r * r
            return m, np.asarray(self.pos, np.float64), np.diag([i, i, i])
        if self.kind == "box":
            hx, hy, hz = self.size[:3]
            m = self.density * 8.0 * hx * hy * hz
            ix = m / 3.0 * (hy * hy + hz * hz)
            iy = m / 3.0 * (hx * hx + hz * hz)
            iz = m / 3.0 * (hx * hx + hy * hy)
            return m, np.asarray(self.pos, np.float64), np.diag([ix, iy, iz])
        if self.kind == "capsule":
            a = np.asarray(self.fromto[:3], np.float64)
            b = np.asarray(self.fromto[3:6], np.float64)
            r = self.size[0]
            h = float(np.linalg.norm(b - a))
            m_cyl = self.density * math.pi * r * r * h
            m_sph = self.density * 4.0 / 3.0 * math.pi * r**3
            m = m_cyl + m_sph
            # inertia about com, z along the segment
            iz = m_cyl * r * r / 2.0 + m_sph * 2.0 * r * r / 5.0
            ixy = (
                m_cyl * (h * h / 12.0 + r * r / 4.0)
                + m_sph * (2.0 * r * r / 5.0 + h * h / 4.0 + 3.0 * h * r / 8.0)
            )
            i_local = np.diag([ixy, ixy, iz])
            com = 0.5 * (a + b)
            # rotate so local z aligns with the segment
            if h > 1e-9:
                z = (b - a) / h
                x = np.array([1.0, 0.0, 0.0])
                if abs(np.dot(x, z)) > 0.9:
                    x = np.array([0.0, 1.0, 0.0])
                y = np.cross(z, x)
                y /= np.linalg.norm(y)
                x = np.cross(y, z)
                r_mat = np.stack([x, y, z], axis=-1)
                i_local = r_mat @ i_local @ r_mat.T
            return m, com, i_local
        if self.kind == "mesh":
            lo = self.verts.min(axis=0)
            hi = self.verts.max(axis=0)
            h = np.maximum((hi - lo) / 2.0, 1e-6)
            m = self.density * 8.0 * float(h[0] * h[1] * h[2])
            ix = m / 3.0 * (h[1] ** 2 + h[2] ** 2)
            iy = m / 3.0 * (h[0] ** 2 + h[2] ** 2)
            iz = m / 3.0 * (h[0] ** 2 + h[1] ** 2)
            com = (lo + hi) / 2.0
            return m, com, np.diag([ix, iy, iz])
        raise ValueError(f"unsupported geom kind {self.kind}")

    def contact_points(self):
        """(offsets[P,3], radii[P]) approximating the geom for hf contact."""
        if self.kind == "sphere":
            return np.asarray([self.pos], np.float64), np.asarray([self.size[0]])
        if self.kind == "capsule":
            a = np.asarray(self.fromto[:3], np.float64)
            b = np.asarray(self.fromto[3:6], np.float64)
            mid = 0.5 * (a + b)
            r = self.size[0]
            return np.stack([a, mid, b]), np.full((3,), r)
        if self.kind == "box":
            hx, hy, hz = self.size[:3]
            corners = np.array(
                [[sx * hx, sy * hy, sz * hz]
                 for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                np.float64,
            )
            q = np.asarray(self.quat, np.float64)
            if abs(q[3] - 1.0) > 1e-9:
                qv, qw = q[:3], q[3]
                t = 2.0 * np.cross(qv, corners)
                corners = corners + qw * t + np.cross(qv, t)
            corners = corners + np.asarray(self.pos, np.float64)
            return corners, np.zeros((8,))
        if self.kind == "mesh":
            # a small farthest-point subset of the vertices (ground contact
            # needs surface extremes, not the full cloud)
            v = np.asarray(self.verts, np.float64)
            pts = [v[np.argmin(v[:, 2])]]
            for _ in range(min(7, len(v) - 1)):
                d = np.min(np.linalg.norm(
                    v[:, None, :] - np.asarray(pts)[None, :, :], axis=-1),
                    axis=-1)
                pts.append(v[np.argmax(d)])
            pts = np.asarray(pts)
            return pts, np.zeros((len(pts),))
        raise ValueError(self.kind)


@dataclasses.dataclass
class JointSpec:
    name: str
    joint_type: str
    axis: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    # per-dof (lo, hi) limits; empty for root/fixed
    limits: Sequence[Tuple[float, float]] = ()
    stiffness: float = 0.0
    damping: float = 0.0
    armature: float = 0.0
    gears: Sequence[float] = ()

    @property
    def dof_dim(self) -> int:
        return _DOF_DIMS[self.joint_type]


@dataclasses.dataclass
class BodySpec:
    name: str
    parent: int
    pos: Tuple[float, float, float]
    joint: JointSpec
    quat: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    geoms: List[GeomSpec] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class CharModelSpec:
    name: str
    bodies: List[BodySpec]

    def build(self, device="cuda") -> "CharModel":
        return build_char_model(self, device=device)


# ---------------------------------------------------------------------------
# Device-side model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CharModel:
    """Static-topology character model: python topology + tensor tables."""

    # --- static topology -------------------------------------------------
    body_names: Tuple[str, ...]
    joint_names: Tuple[str, ...]
    parent_indices: Tuple[int, ...]
    joint_types: Tuple[str, ...]
    dof_offsets: Tuple[int, ...]  # per joint
    dof_size: int
    num_bodies: int

    # --- kinematic arrays -------------------------------------------------
    local_translation: torch.Tensor  # (J, 3)
    local_rotation: torch.Tensor     # (J, 4)
    joint_axes: torch.Tensor         # (J, 3) hinge axis (unused otherwise)
    dof_limits_lower: torch.Tensor   # (D,)
    dof_limits_upper: torch.Tensor   # (D,)

    # --- actuation / dynamics arrays --------------------------------------
    dof_stiffness: torch.Tensor      # (D,) PD kp per dof
    dof_damping: torch.Tensor        # (D,) PD kd per dof
    dof_armature: torch.Tensor       # (D,)
    dof_motor_effort: torch.Tensor   # (D,) torque limit (actuator gear)

    # --- mass properties (per body, body frame) ---------------------------
    body_mass: torch.Tensor          # (J,)
    body_com: torch.Tensor           # (J, 3)
    body_inertia: torch.Tensor       # (J, 3, 3) about com

    # --- contact geometry --------------------------------------------------
    contact_point_body: torch.Tensor    # (P,) int64 body index per point
    contact_point_offset: torch.Tensor  # (P, 3) body-frame offsets
    contact_point_radius: torch.Tensor  # (P,)

    # --- dof <-> per-joint exp-map mapping ---------------------------------
    # dof_map[j] maps the D-dof vector to joint j+1's local exp-map/angular
    # rate: spherical -> identity block, hinge -> unit axis column.
    dof_map: torch.Tensor              # (J-1, 3, D)

    # per-device tables derived from this model (the control-step kernel's
    # packed constants); filled on first use, dropped by replace()/to()
    derived: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @property
    def device(self) -> torch.device:
        return self.body_mass.device

    def joint_dof_slice(self, j: int):
        return self.dof_offsets[j], self.dof_offsets[j] + _DOF_DIMS[self.joint_types[j]]

    def replace(self, **changes) -> "CharModel":
        return dataclasses.replace(self, derived={}, **changes)

    def to(self, device) -> "CharModel":
        device = torch.device(device)
        if self.device == device:
            return self
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return self.replace(**moved)


def build_char_model(spec: CharModelSpec, device="cuda") -> CharModel:
    """Tables of a CharModelSpec, built in float64 and stored in float32,
    on ``device`` (the card unless the caller asks for the CPU)."""
    bodies = spec.bodies
    n = len(bodies)
    parent_indices = tuple(b.parent for b in bodies)
    joint_types = tuple(b.joint.joint_type for b in bodies)

    dof_offsets, off = [], 0
    for b in bodies:
        dof_offsets.append(off)
        off += b.joint.dof_dim
    dof_size = off

    local_translation = np.asarray([b.pos for b in bodies], np.float64)
    local_rotation = np.asarray([b.quat for b in bodies], np.float64)
    joint_axes = np.asarray([b.joint.axis for b in bodies], np.float64)

    lo = np.zeros(dof_size)
    hi = np.zeros(dof_size)
    kp = np.zeros(dof_size)
    kd = np.zeros(dof_size)
    arm = np.zeros(dof_size)
    effort = np.zeros(dof_size)
    for b, o in zip(bodies, dof_offsets):
        d = b.joint.dof_dim
        if d == 0:
            continue
        lim = list(b.joint.limits) or [(-np.pi, np.pi)] * d
        for k in range(d):
            lo[o + k], hi[o + k] = lim[k]
        kp[o:o + d] = b.joint.stiffness
        kd[o:o + d] = b.joint.damping
        arm[o:o + d] = b.joint.armature
        gears = list(b.joint.gears) or [0.0] * d
        for k in range(d):
            effort[o + k] = gears[k]

    mass = np.zeros(n)
    com = np.zeros((n, 3))
    inertia = np.zeros((n, 3, 3))
    cp_body, cp_off, cp_rad = [], [], []
    for i, b in enumerate(bodies):
        m_tot, m_com, m_i = 0.0, np.zeros(3), np.zeros((3, 3))
        for g in b.geoms:
            gm, gcom, gin = g.mass_properties()
            m_tot += gm
            m_com += gm * gcom
            # parallel axis to origin
            d = gcom
            m_i += gin + gm * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
            pts, rads = g.contact_points()
            cp_body.extend([i] * len(pts))
            cp_off.extend(list(pts))
            cp_rad.extend(list(rads))
        if m_tot > 0:
            m_com /= m_tot
            # move inertia from origin back to com
            d = m_com
            m_i -= m_tot * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
        mass[i] = m_tot
        com[i] = m_com
        inertia[i] = m_i

    dof_map = np.zeros((n - 1, 3, dof_size))
    for j in range(1, n):
        b = bodies[j]
        o = dof_offsets[j]
        if b.joint.joint_type == SPHERICAL:
            dof_map[j - 1, :, o:o + 3] = np.eye(3)
        elif b.joint.joint_type == HINGE:
            axis = np.asarray(b.joint.axis, np.float64)
            dof_map[j - 1, :, o] = axis / np.linalg.norm(axis)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    model = CharModel(
        body_names=tuple(b.name for b in bodies),
        joint_names=tuple(b.joint.name for b in bodies),
        parent_indices=parent_indices,
        joint_types=joint_types,
        dof_offsets=tuple(dof_offsets),
        dof_size=dof_size,
        num_bodies=n,
        local_translation=f32(local_translation),
        local_rotation=f32(local_rotation),
        joint_axes=f32(joint_axes),
        dof_limits_lower=f32(lo),
        dof_limits_upper=f32(hi),
        dof_stiffness=f32(kp),
        dof_damping=f32(kd),
        dof_armature=f32(arm),
        dof_motor_effort=f32(effort),
        body_mass=f32(mass),
        body_com=f32(com),
        body_inertia=f32(inertia),
        contact_point_body=torch.as_tensor(np.asarray(cp_body, np.int64)),
        contact_point_offset=f32(np.asarray(cp_off)),
        contact_point_radius=f32(np.asarray(cp_rad)),
        dof_map=f32(dof_map),
    )
    return model.to(resolve_device(device))


# ---------------------------------------------------------------------------
# MJCF parsing (generic; merges triples of hinges into spherical joints)
# ---------------------------------------------------------------------------


def load_mesh_vertices(path: str) -> np.ndarray:
    """Mesh vertices from an .obj (ascii) or .stl (binary or ascii) file.

    Only the vertices are read: the mass properties and contact points are
    derived from them (GeomSpec), so no mesh library is needed.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        verts = []
        with open(path) as f:
            for line in f:
                if line.startswith("v "):
                    parts = line.split()
                    verts.append([float(parts[1]), float(parts[2]),
                                  float(parts[3])])
        if not verts:
            raise ValueError("no vertices in OBJ")
        return np.asarray(verts, np.float64)
    if ext == ".stl":
        with open(path, "rb") as f:
            data = f.read()
        if data[:5] == b"solid" and b"facet" in data[:500]:
            verts = []
            for line in data.decode(errors="ignore").splitlines():
                line = line.strip()
                if line.startswith("vertex"):
                    parts = line.split()
                    verts.append([float(parts[1]), float(parts[2]),
                                  float(parts[3])])
            if not verts:
                raise ValueError("no vertices in ascii STL")
            return np.unique(np.asarray(verts, np.float64), axis=0)
        n_tri = _struct.unpack("<I", data[80:84])[0]
        verts = np.frombuffer(
            data, np.uint8, count=n_tri * 50, offset=84
        ).reshape(n_tri, 50)[:, 12:48].copy().view("<f4").reshape(-1, 3)
        return np.unique(verts.astype(np.float64), axis=0)
    raise ValueError(f"unsupported mesh format {ext!r}")


def _parse_vec(s, default):
    if s is None:
        return tuple(default)
    return tuple(float(x) for x in s.split())


def _parse_quat_wxyz(s):
    """An MJCF quat (w x y z) as the port's (x, y, z, w)."""
    if s is None:
        return (0.0, 0.0, 0.0, 1.0)
    w, x, y, z = (float(v) for v in s.split())
    return (x, y, z, w)


def parse_mjcf(path: str) -> CharModelSpec:
    """Parse an MJCF file into a CharModelSpec.

    Supports the subset used by PARC-style characters: nested bodies with
    0/1/3 hinge joints (three become one spherical joint), sphere / box /
    capsule / mesh geoms with densities, mesh assets (.obj, .stl) with a
    scale, joint defaults, and a root-level <actuator> block of motors
    keyed by joint name.
    """
    tree = ET.parse(path)
    root_el = tree.getroot()

    # mesh assets (<asset><mesh name file [scale]>)
    meshes: Dict[str, np.ndarray] = {}
    asset_el = root_el.find("asset")
    if asset_el is not None:
        base = os.path.dirname(os.path.abspath(path))
        for mel in asset_el.findall("mesh"):
            fname = mel.attrib.get("file")
            if not fname:
                continue
            scale = _parse_vec(mel.attrib.get("scale"), (1.0, 1.0, 1.0))
            try:
                v = load_mesh_vertices(os.path.join(base, fname))
                meshes[mel.attrib.get("name",
                                      os.path.splitext(fname)[0])] = (
                    v * np.asarray(scale, np.float64))
            except (OSError, ValueError) as e:
                print(f"warning: mesh asset {fname!r} skipped: {e}")

    # actuator gears by joint name
    gears = {}
    act = root_el.find("actuator")
    if act is not None:
        for motor in act.findall("motor"):
            gears[motor.attrib["joint"]] = float(motor.attrib.get("gear", 1.0))

    # defaults (class="body")
    default_joint = {}
    default_geom_type = "sphere"
    default_el = root_el.find("default")
    if default_el is not None:
        for sub in default_el.iter("default"):
            j = sub.find("joint")
            if j is not None:
                default_joint = dict(j.attrib)
            g = sub.find("geom")
            if g is not None and "type" in g.attrib:
                default_geom_type = g.attrib["type"]

    bodies: List[BodySpec] = []

    def parse_joints(body_name, joint_els) -> JointSpec:
        if len(joint_els) == 0:
            return JointSpec(name=body_name, joint_type=FIXED)
        if len(joint_els) == 1:
            el = joint_els[0]
            attrib = {**default_joint, **el.attrib}
            lo, hi = _parse_vec(attrib.get("range"), (-180.0, 180.0))
            return JointSpec(
                name=el.attrib.get("name", body_name),
                joint_type=HINGE,
                axis=_parse_vec(attrib.get("axis"), (0, 0, 1)),
                limits=[(math.radians(lo), math.radians(hi))],
                stiffness=float(attrib.get("stiffness", 0.0)),
                damping=float(attrib.get("damping", 0.0)),
                armature=float(attrib.get("armature", 0.0)),
                gears=[gears.get(el.attrib.get("name", ""), 0.0)],
            )
        if len(joint_els) == 3:
            limits, g = [], []
            attrib = {**default_joint, **joint_els[0].attrib}
            for el in joint_els:
                a = {**default_joint, **el.attrib}
                lo, hi = _parse_vec(a.get("range"), (-180.0, 180.0))
                limits.append((math.radians(lo), math.radians(hi)))
                g.append(gears.get(el.attrib.get("name", ""), 0.0))
            name = joint_els[0].attrib.get("name", body_name)
            for suffix in ("_x", "_y", "_z"):
                if name.endswith(suffix):
                    name = name[: -len(suffix)]
            return JointSpec(
                name=name, joint_type=SPHERICAL, limits=limits,
                stiffness=float(attrib.get("stiffness", 0.0)),
                damping=float(attrib.get("damping", 0.0)),
                armature=float(attrib.get("armature", 0.0)),
                gears=g,
            )
        raise ValueError("series joints are not supported")

    def parse_geom(el) -> GeomSpec:
        kind = el.attrib.get("type", default_geom_type)
        density = float(el.attrib.get("density", 1000.0))
        quat = _parse_quat_wxyz(el.attrib.get("quat"))
        if kind == "capsule":
            fromto = _parse_vec(el.attrib.get("fromto"), (0,) * 6)
            return GeomSpec("capsule", fromto=fromto,
                            size=(float(el.attrib.get("size", 0.1)),),
                            density=density, quat=quat)
        pos = _parse_vec(el.attrib.get("pos"), (0, 0, 0))
        if kind == "mesh":
            name = el.attrib.get("mesh", "")
            if name not in meshes:
                raise ValueError(f"geom references unknown mesh {name!r}")
            v = meshes[name].copy()
            q = np.asarray(quat, np.float64)
            if abs(q[3] - 1.0) > 1e-9:
                qv, qw = q[:3], q[3]
                t = 2.0 * np.cross(qv, v)
                v = v + qw * t + np.cross(qv, t)
            v = v + np.asarray(pos, np.float64)
            return GeomSpec("mesh", pos=pos, density=density, quat=quat,
                            verts=v)
        size = _parse_vec(el.attrib.get("size"), (0.1,))
        return GeomSpec(kind, pos=pos, size=size, density=density, quat=quat)

    def walk(el, parent_idx):
        idx = len(bodies)
        joint_els = el.findall("joint")
        if parent_idx == -1 and (el.find("freejoint") is not None
                                 or not joint_els):
            joint = JointSpec(name="root", joint_type=ROOT)
        else:
            joint = parse_joints(el.attrib.get("name", f"body{idx}"),
                                 joint_els)
        bodies.append(
            BodySpec(
                name=el.attrib.get("name", f"body{idx}"),
                parent=parent_idx,
                pos=_parse_vec(el.attrib.get("pos"), (0, 0, 0)),
                quat=_parse_quat_wxyz(el.attrib.get("quat")),
                joint=joint,
                geoms=[parse_geom(g) for g in el.findall("geom")],
            )
        )
        for child in el.findall("body"):
            walk(child, idx)

    world = root_el.find("worldbody")
    walk(world.find("body"), -1)
    return CharModelSpec(name=root_el.attrib.get("model", "char"),
                         bodies=bodies)


def load_char_file(path: str, device="cuda") -> CharModel:
    """The CharModel of an MJCF file, on ``device``."""
    return parse_mjcf(path).build(device=device)


def export_mjcf(spec: CharModelSpec) -> str:
    """Re-export a CharModelSpec as an MJCF document (reference:
    anim/kin_char_model.py:756-931) that :func:`parse_mjcf` reads back:
    spherical joints as three hinges, mesh geoms as their bounding box."""
    root = ET.Element("mujoco", model=spec.name)
    world = ET.SubElement(root, "worldbody")

    def fmt(vals):
        return " ".join(f"{float(v):.6g}" for v in vals)

    elems = {}
    for i, b in enumerate(spec.bodies):
        parent_el = world if b.parent < 0 else elems[b.parent]
        el = ET.SubElement(parent_el, "body", name=b.name, pos=fmt(b.pos))
        q = b.quat
        if abs(q[3] - 1.0) > 1e-9 or any(abs(x) > 1e-9 for x in q[:3]):
            # MJCF quats are wxyz
            el.set("quat", fmt([q[3], q[0], q[1], q[2]]))
        elems[i] = el
        j = b.joint
        common = {}
        if j.stiffness:
            common["stiffness"] = f"{j.stiffness:.6g}"
        if j.damping:
            common["damping"] = f"{j.damping:.6g}"
        if j.armature:
            common["armature"] = f"{j.armature:.6g}"
        if j.joint_type == ROOT:
            ET.SubElement(el, "freejoint", name=j.name)
        elif j.joint_type == SPHERICAL:
            # three hinges, the source MJCF convention the parser merges
            # back into one spherical joint
            axes = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
            for k, suffix in enumerate(("_x", "_y", "_z")):
                jel = ET.SubElement(el, "joint", name=j.name + suffix,
                                    type="hinge", axis=fmt(axes[k]),
                                    **common)
                if k < len(j.limits):
                    jel.set("range", fmt([math.degrees(v)
                                          for v in j.limits[k]]))
        elif j.joint_type == HINGE:
            jel = ET.SubElement(el, "joint", name=j.name, type="hinge",
                                axis=fmt(j.axis), **common)
            if j.limits:
                jel.set("range", fmt([math.degrees(v)
                                      for v in j.limits[0]]))
        for g in b.geoms:
            if g.kind == "mesh":
                # a mesh re-exports as its bounding box (the asset file is
                # not written), so the document stands alone
                lo, hi = g.verts.min(axis=0), g.verts.max(axis=0)
                gel = ET.SubElement(el, "geom", type="box",
                                    pos=fmt((lo + hi) / 2.0),
                                    size=fmt((hi - lo) / 2.0))
                if g.density != 1000.0:
                    gel.set("density", f"{g.density:.6g}")
                continue
            gel = ET.SubElement(el, "geom", type=g.kind)
            if g.kind == "capsule":
                gel.set("fromto", fmt(g.fromto))
                gel.set("size", fmt(g.size[:1]))
            else:
                gel.set("pos", fmt(g.pos))
                gel.set("size", fmt(g.size[:3] if g.kind == "box"
                                    else g.size[:1]))
            if g.density != 1000.0:
                gel.set("density", f"{g.density:.6g}")
    ET.indent(root)
    return ET.tostring(root, encoding="unicode")


# ---------------------------------------------------------------------------
# Pure kinematic functions
# ---------------------------------------------------------------------------


def joint_exp_maps(model: CharModel, dof: torch.Tensor) -> torch.Tensor:
    """(..., D) dof vector -> (..., J-1, 3) per-joint exp-maps."""
    return torch.einsum("jkd,...d->...jk", model.dof_map, dof)


def project_to_dof(model: CharModel, per_joint: torch.Tensor) -> torch.Tensor:
    """(..., J-1, 3) per-joint exp-maps/rates -> (..., D) dof vector."""
    return torch.einsum("jkd,...jk->...d", model.dof_map, per_joint)


def dof_to_rot(model: CharModel, dof: torch.Tensor) -> torch.Tensor:
    """(..., D) dof vector -> (..., J-1, 4) joint quaternions.

    Hinge rotations equal exp(axis * theta), so one exp-map covers hinge,
    spherical, and fixed (zero exp-map -> identity) joints.
    """
    return rot.exp_map_to_quat(joint_exp_maps(model, dof))


def rot_to_dof(model: CharModel, joint_rot: torch.Tensor) -> torch.Tensor:
    """(..., J-1, 4) joint quaternions -> (..., D) dof vector."""
    return project_to_dof(model, rot.quat_to_exp_map(joint_rot))


def forward_kinematics(model: CharModel, root_pos: torch.Tensor,
                       root_rot: torch.Tensor, joint_rot: torch.Tensor):
    """FK over the body tree.

    Args:
      root_pos: (..., 3) world root position.
      root_rot: (..., 4) world root orientation.
      joint_rot: (..., J-1, 4) local joint rotations.

    Returns:
      body_pos (..., J, 3) and body_rot (..., J, 4) world transforms.
    """
    body_pos = [root_pos]
    body_rot = [root_rot]
    for j in range(1, model.num_bodies):
        parent = model.parent_indices[j]
        p_pos, p_rot = body_pos[parent], body_rot[parent]
        world_t = rot.quat_rotate(
            p_rot, model.local_translation[j].expand(p_pos.shape))
        cur_rot = rot.quat_mul(model.local_rotation[j].expand(p_rot.shape),
                               joint_rot[..., j - 1, :])
        body_pos.append(p_pos + world_t)
        body_rot.append(rot.quat_mul(p_rot, cur_rot))
    return torch.stack(body_pos, dim=-2), torch.stack(body_rot, dim=-2)


def compute_dof_vel(model: CharModel, joint_rot0: torch.Tensor,
                    joint_rot1: torch.Tensor, dt) -> torch.Tensor:
    """Finite-difference dof velocities between two joint rotation frames."""
    drot = rot.quat_normalize(
        rot.quat_mul(rot.quat_conjugate(joint_rot0), joint_rot1))
    return project_to_dof(model, rot.quat_to_exp_map(drot) / dt)


def compute_frame_dof_vel(model: CharModel, joint_rot: torch.Tensor,
                          dt) -> torch.Tensor:
    """Per-frame dof velocities for a (..., T, J-1, 4) sequence (last repeated)."""
    dof_vel = compute_dof_vel(model, joint_rot[..., :-1, :, :],
                              joint_rot[..., 1:, :, :], dt)
    return torch.cat([dof_vel, dof_vel[..., -1:, :]], dim=-2)


def clamp_dof(model: CharModel, dof: torch.Tensor,
              margin: float = 0.0) -> torch.Tensor:
    """``dof`` clamped to the joint limits pulled in by ``margin``."""
    return torch.clamp(dof, model.dof_limits_lower + margin,
                       model.dof_limits_upper - margin)


def body_vel_from_dof_vel(model: CharModel, body_rot: torch.Tensor,
                          root_vel: torch.Tensor, root_ang_vel: torch.Tensor,
                          body_pos: torch.Tensor, dof_vel: torch.Tensor):
    """Propagate world linear/angular velocities down the tree.

    Joint dof velocities are local (child-frame) angular velocities; each
    body's world angular velocity is its parent's plus the joint rate
    rotated into world via the body's own frame.
    """
    w_locals = joint_exp_maps(model, dof_vel)  # (..., J-1, 3)
    w_worlds = rot.quat_rotate(body_rot[..., 1:, :], w_locals)
    ang = [root_ang_vel]
    lin = [root_vel]
    for j in range(1, model.num_bodies):
        parent = model.parent_indices[j]
        w = ang[parent] + w_worlds[..., j - 1, :]
        r = body_pos[..., j, :] - body_pos[..., parent, :]
        v = lin[parent] + rot.cross(ang[parent], r)
        ang.append(w)
        lin.append(v)
    return torch.stack(lin, dim=-2), torch.stack(ang, dim=-2)
