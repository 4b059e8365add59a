"""Minimal URDF robot model + batched FK for retargeting targets.

Reference parity: pyroki_retarget/_robot_urdf_parser.py (RobotURDFParser:
joint topology sort, actuated/mimic joint maps, limits, parent-frame
transforms) + 10_humanoid_retargeting.py (SMPL keypoints -> Unitree G1).
The reference builds a pyroki Robot from yourdfpy; here a stdlib XML
parse produces host-numpy constant tables (host code), and the FK runs
the joint loop in Python over batched tensors — (T, nq) in, (T, L, 3)
out — so one call covers a whole trajectory on the device of ``q``.

No external URDF package: xml.etree only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple
import xml.etree.ElementTree as ET

import numpy as np
import torch

from parc_torch import resolve_device
from parc_torch.retarget.keypoint_ik import (SMPL_JOINT_NAMES, adam_fit,
                                             keypoint_losses)
from parc_torch.utils import rotation as rot
from parc_torch.utils import terrain as terrain_lib


def _rpy_to_quat(rpy: np.ndarray) -> np.ndarray:
    """URDF fixed-axis XYZ euler -> xyzw quat (host, float32, parse
    time)."""
    r, p, y = (torch.tensor(float(v), dtype=torch.float32) for v in rpy[:3])
    return rot.quat_from_euler_xyz(r, p, y).numpy()


@dataclasses.dataclass(frozen=True)
class UrdfJoint:
    name: str
    jtype: str                 # revolute | continuous | prismatic | fixed
    parent: str
    child: str
    origin_xyz: np.ndarray     # (3,) joint frame in the parent link frame
    origin_quat: np.ndarray    # (4,) xyzw
    axis: np.ndarray           # (3,)
    lower: float
    upper: float
    act_idx: int               # index into the actuated config, -1 = fixed
    mimic_idx: int             # actuated index this joint mimics, -1 = none
    mimic_mult: float
    mimic_off: float


@dataclasses.dataclass(frozen=True)
class UrdfRobot:
    """Parsed robot: joints in topological (parent-before-child) order.

    ``link_names[0]`` is the root link; ``parent_link_idx[j]`` /
    ``child_link_idx[j]`` index ``link_names`` for ``joints[j]``.
    """
    name: str
    joints: Tuple[UrdfJoint, ...]
    link_names: Tuple[str, ...]
    parent_link_idx: np.ndarray
    child_link_idx: np.ndarray
    num_dofs: int
    actuated_names: Tuple[str, ...]

    @property
    def lower_limits(self) -> np.ndarray:
        lo = np.zeros(self.num_dofs, np.float32)
        for j in self.joints:
            if j.act_idx >= 0:
                lo[j.act_idx] = j.lower
        return lo

    @property
    def upper_limits(self) -> np.ndarray:
        hi = np.zeros(self.num_dofs, np.float32)
        for j in self.joints:
            if j.act_idx >= 0:
                hi[j.act_idx] = j.upper
        return hi

    def link_index(self, name: str) -> int:
        return self.link_names.index(name)


def parse_urdf(path_or_str: str) -> UrdfRobot:
    """Parse a URDF file (or raw XML string) into a :class:`UrdfRobot`.

    Supports revolute/continuous/prismatic/fixed joints, mimic joints,
    and per-joint origins/axes/limits — the subset the reference parser
    feeds retargeting (pyroki_retarget/_robot_urdf_parser.py:208-353).
    """
    if path_or_str.lstrip().startswith("<"):
        root = ET.fromstring(path_or_str)
    else:
        root = ET.parse(path_or_str).getroot()
    if root.tag != "robot":
        raise ValueError(f"not a URDF: root tag {root.tag!r}")

    def vec(el, attr, default):
        return np.asarray((el.get(attr, default) if el is not None
                           else default).split(), np.float64)

    links = [ln.get("name") for ln in root.findall("link")]
    raw = []
    for el in root.findall("joint"):
        origin = el.find("origin")
        limit = el.find("limit")
        lower = float(limit.get("lower", "0")) if limit is not None else 0.0
        upper = float(limit.get("upper", "0")) if limit is not None else 0.0
        jtype = el.get("type")
        if jtype == "continuous":
            lower, upper = -np.pi, np.pi
        mimic = el.find("mimic")
        raw.append(dict(
            name=el.get("name"), jtype=jtype,
            parent=el.find("parent").get("link"),
            child=el.find("child").get("link"),
            xyz=vec(origin, "xyz", "0 0 0").astype(np.float32),
            quat=_rpy_to_quat(vec(origin, "rpy", "0 0 0")),
            axis=vec(el.find("axis"), "xyz", "1 0 0").astype(np.float32),
            lower=lower, upper=upper,
            mimic=(None if mimic is None else
                   (mimic.get("joint"), float(mimic.get("multiplier", "1")),
                    float(mimic.get("offset", "0"))))))

    # root link = the one that is never a child
    children = {j["child"] for j in raw}
    roots = [ln for ln in links if ln not in children]
    if len(roots) != 1:
        raise ValueError(f"expected exactly one root link, got {roots}")

    # topological order: BFS from the root (reference
    # _robot_urdf_parser._topologically_sort_joints)
    by_parent: Dict[str, List[dict]] = {}
    for j in raw:
        by_parent.setdefault(j["parent"], []).append(j)
    ordered: List[dict] = []
    frontier = [roots[0]]
    while frontier:
        link = frontier.pop(0)
        for j in by_parent.get(link, []):
            ordered.append(j)
            frontier.append(j["child"])
    if len(ordered) != len(raw):
        orphans = {j["name"] for j in raw} - {j["name"] for j in ordered}
        raise ValueError(f"disconnected joints: {sorted(orphans)}")

    # actuated config: non-fixed, non-mimic joints in topological order
    act_names, act_of = [], {}
    for j in ordered:
        if j["jtype"] != "fixed" and j["mimic"] is None:
            act_of[j["name"]] = len(act_names)
            act_names.append(j["name"])

    link_names = [roots[0]] + [j["child"] for j in ordered]
    link_idx = {n: i for i, n in enumerate(link_names)}
    joints, p_idx, c_idx = [], [], []
    for j in ordered:
        mimic_idx, mult, off = -1, 1.0, 0.0
        if j["mimic"] is not None:
            tgt, mult, off = j["mimic"]
            if tgt not in act_of:
                raise ValueError(f"mimic target {tgt!r} is not actuated")
            mimic_idx = act_of[tgt]
        joints.append(UrdfJoint(
            name=j["name"], jtype=j["jtype"], parent=j["parent"],
            child=j["child"], origin_xyz=j["xyz"], origin_quat=j["quat"],
            axis=j["axis"], lower=j["lower"], upper=j["upper"],
            act_idx=act_of.get(j["name"], -1), mimic_idx=mimic_idx,
            mimic_mult=mult, mimic_off=off))
        p_idx.append(link_idx[j["parent"]])
        c_idx.append(link_idx[j["child"]])

    return UrdfRobot(
        name=root.get("name", "robot"), joints=tuple(joints),
        link_names=tuple(link_names),
        parent_link_idx=np.asarray(p_idx, np.int32),
        child_link_idx=np.asarray(c_idx, np.int32),
        num_dofs=len(act_names), actuated_names=tuple(act_names))


_TABLES: Dict[tuple, tuple] = {}


def _joint_tables(robot: UrdfRobot, device, dtype):
    """Each joint's origin translation, origin quaternion and axis as
    tensors on ``device``, made once per robot, device and dtype (so that
    FK copies nothing from the host and can be captured in a CUDA
    graph)."""
    key = (id(robot), str(device), dtype)
    hit = _TABLES.get(key)
    if hit is None or hit[0] is not robot:
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        hit = (robot, [(t(j.origin_xyz), t(j.origin_quat), t(j.axis))
                       for j in robot.joints])
        _TABLES[key] = hit
    return hit[1]


def forward_kinematics(robot: UrdfRobot, q: torch.Tensor,
                       root_pos: Optional[torch.Tensor] = None,
                       root_quat: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched FK: ``q`` (..., nq) -> link positions (..., L, 3) and
    orientations (..., L, 4) in world frame, on ``q``'s device.

    The joint loop runs in Python over the static topology; every batch
    dimension stays vectorized, so one call computes a whole trajectory.
    """
    batch = q.shape[:-1]
    dev, dt = q.device, q.dtype
    if root_pos is None:
        root_pos = torch.zeros(batch + (3,), dtype=dt, device=dev)
    if root_quat is None:
        root_quat = torch.zeros(batch + (4,), dtype=dt, device=dev)
        root_quat[..., 3] = 1.0

    pos = [None] * len(robot.link_names)
    quat = [None] * len(robot.link_names)
    pos[0], quat[0] = root_pos, root_quat
    for j, (joint, (o_xyz, o_q, axis)) in enumerate(
            zip(robot.joints, _joint_tables(robot, dev, dt))):
        p = int(robot.parent_link_idx[j])
        c = int(robot.child_link_idx[j])
        # parent ∘ origin
        o_pos = pos[p] + rot.quat_rotate(quat[p], o_xyz.expand(batch + (3,)))
        o_quat = rot.quat_mul(quat[p], o_q.expand(batch + (4,)))
        if joint.jtype == "fixed":
            pos[c], quat[c] = o_pos, o_quat
            continue
        if joint.act_idx >= 0:
            qj = q[..., joint.act_idx]
        else:  # mimic
            qj = q[..., joint.mimic_idx] * joint.mimic_mult + joint.mimic_off
        if joint.jtype == "prismatic":
            pos[c] = o_pos + rot.quat_rotate(o_quat, axis * qj[..., None])
            quat[c] = o_quat
        else:  # revolute / continuous
            jq = rot.axis_angle_to_quat(axis.expand(batch + (3,)), qj)
            pos[c] = o_pos
            quat[c] = rot.quat_mul(o_quat, jq)
    return torch.stack(pos, dim=-2), torch.stack(quat, dim=-2)


# ---------------------------------------------------------------------------
# SMPL -> robot (G1) retargeting
# ---------------------------------------------------------------------------

# SMPL joint -> G1 link correspondence
# (reference: pyroki_retarget/_utils.get_humanoid_retarget_indices)
SMPL_TO_G1: Dict[str, str] = {
    "pelvis": "pelvis",
    "left_hip": "left_hip_pitch_link",
    "right_hip": "right_hip_pitch_link",
    "left_knee": "left_knee_link",
    "right_knee": "right_knee_link",
    "left_ankle": "left_ankle_roll_link",
    "right_ankle": "right_ankle_roll_link",
    "left_shoulder": "left_shoulder_roll_link",
    "right_shoulder": "right_shoulder_roll_link",
    "left_elbow": "left_elbow_link",
    "right_elbow": "right_elbow_link",
    "left_wrist": "left_rubber_hand",
    "right_wrist": "right_rubber_hand",
}


@dataclasses.dataclass(frozen=True)
class UrdfRetargetConfig:
    iters: int = 1500
    lr: float = 0.02
    w_global: float = 1.0     # absolute keypoint alignment
    w_local: float = 2.0      # root-relative alignment
    w_smooth: float = 0.5     # second-difference smoothness
    w_limits: float = 10.0    # joint-limit barrier
    w_scale_reg: float = 1.0
    optimize_scale: bool = True


def retarget_keypoints_to_robot(
        robot: UrdfRobot, keypoints: np.ndarray,
        mapping: Dict[str, str] = SMPL_TO_G1,
        keypoint_names: Optional[Sequence[str]] = None,
        cfg: UrdfRetargetConfig = UrdfRetargetConfig(), device="cuda"):
    """Retarget a (T, K, 3) SMPL keypoint trajectory onto a URDF robot, on
    ``device`` (the card unless the caller asks for the CPU).

    Returns ``(root_pos (T,3), root_quat (T,4), q (T,nq), losses)`` —
    the role of pyroki_retarget/10_humanoid_retargeting.py's jaxls solve,
    as one Adam loop over the whole trajectory.
    """
    dev = resolve_device(device)
    keypoint_names = list(keypoint_names or SMPL_JOINT_NAMES)
    kp_idx, link_idx = [], []
    for kp_name, link_name in mapping.items():
        if kp_name in keypoint_names and link_name in robot.link_names:
            kp_idx.append(keypoint_names.index(kp_name))
            link_idx.append(robot.link_index(link_name))
    assert len(kp_idx) >= 4, "need at least 4 keypoint correspondences"
    target = torch.as_tensor(np.asarray(keypoints, np.float32)[:, kp_idx],
                             device=dev)
    link_idx = torch.as_tensor(link_idx, dtype=torch.long, device=dev)
    t_len = keypoints.shape[0]
    lo = torch.as_tensor(robot.lower_limits, device=dev)
    hi = torch.as_tensor(robot.upper_limits, device=dev)

    def loss_fn(x):
        root_pos = x["root_pos"]
        pos, _ = forward_kinematics(robot, x["q"], root_pos,
                                    rot.exp_map_to_quat(x["root_rot"]))
        scale = x["scale"] if cfg.optimize_scale else None
        rel = pos - root_pos[..., None, :]
        if scale is not None:
            rel = rel * scale
        pts = (root_pos[..., None, :] + rel)[:, link_idx]
        return keypoint_losses(pts, target, x["q"], root_pos, scale, lo, hi,
                               cfg)

    x = {
        "root_pos": target[:, 0].clone(),
        "root_rot": torch.zeros((t_len, 3), device=dev),
        "q": torch.zeros((t_len, robot.num_dofs), device=dev),
        "scale": torch.ones((), device=dev),
    }
    if not cfg.optimize_scale:
        # unused by the loss: its gradient is zero and Adam leaves it at 1
        del x["scale"]
    for v in x.values():
        v.requires_grad_(True)
    losses = adam_fit(x, loss_fn, cfg.iters, cfg.lr)
    with torch.no_grad():
        root_quat = rot.exp_map_to_quat(x["root_rot"])
        q = terrain_lib.clip(x["q"], lo, hi)
    return (x["root_pos"].detach().cpu().numpy(), root_quat.cpu().numpy(),
            q.cpu().numpy(), losses)
