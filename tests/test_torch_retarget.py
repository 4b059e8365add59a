"""parc_torch.retarget (keypoint IK onto a CharModel, the URDF parser, URDF
forward kinematics and keypoint IK onto a URDF robot) against
parc_tpu.retarget, on the same numpy inputs. The URDFs are
tests/test_retarget.py's inline ones (the arm with a fixed and a
prismatic joint, and the mimic chain), plus one with rotated origins and a
continuous joint.

Tolerances (f32):
- parsed tables: exact (origin quaternions from rpy: 1e-7);
- URDF FK and the humanoid's keypoints: 1e-5 absolute;
- IK after 5 Adam iterations (optax.adam against torch.optim.Adam, both
  adding eps to the bias-corrected sqrt(v)): the optimized variables and
  frames within 2 lr = 4e-2 (Adam's normalized step turns rounding noise
  in a near-zero gradient into up to lr a step, as
  tests/test_torch_mdm.py holds Adam); the
  final loss terms within 1e-3 of the total.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.data.synthetic import walking_clip
from parc_tpu.retarget import keypoint_ik as jik
from parc_tpu.retarget import urdf as jurdf
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.retarget import keypoint_ik as tik
from parc_torch.retarget import urdf as turdf
from test_torch_diffusion import _close, _t

torch.set_num_threads(1)

LR = 0.02

ARM = """
<robot name="arm">
  <link name="base"/>
  <link name="upper"/>
  <link name="fore"/>
  <link name="hand"/>
  <link name="tool"/>
  <joint name="shoulder" type="revolute">
    <parent link="base"/><child link="upper"/>
    <origin xyz="0 0 1" rpy="0 0 0"/>
    <axis xyz="0 0 1"/>
    <limit lower="-1.5" upper="1.5"/>
  </joint>
  <joint name="elbow" type="revolute">
    <parent link="upper"/><child link="fore"/>
    <origin xyz="1 0 0" rpy="0 0 0"/>
    <axis xyz="0 0 1"/>
    <limit lower="-2.0" upper="2.0"/>
  </joint>
  <joint name="wrist" type="fixed">
    <parent link="fore"/><child link="hand"/>
    <origin xyz="0.5 0 0" rpy="0 0 0"/>
  </joint>
  <joint name="slider" type="prismatic">
    <parent link="hand"/><child link="tool"/>
    <origin xyz="0 0 0" rpy="0 0 0"/>
    <axis xyz="0 0 1"/>
    <limit lower="0" upper="0.3"/>
  </joint>
</robot>
"""

MIMIC = """
<robot name="m">
  <link name="a"/><link name="b"/><link name="c"/>
  <joint name="j1" type="revolute">
    <parent link="a"/><child link="b"/>
    <origin xyz="1 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-3" upper="3"/>
  </joint>
  <joint name="j2" type="revolute">
    <parent link="b"/><child link="c"/>
    <origin xyz="1 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-3" upper="3"/>
    <mimic joint="j1" multiplier="0.5" offset="0"/>
  </joint>
</robot>"""

TILTED = """
<robot name="t">
  <link name="root"/><link name="l1"/><link name="l2"/><link name="l3"/>
  <link name="l4"/>
  <joint name="a" type="continuous">
    <parent link="root"/><child link="l1"/>
    <origin xyz="0.1 0.2 0.3" rpy="0.3 -0.2 0.9"/><axis xyz="0 1 1"/>
  </joint>
  <joint name="b" type="revolute">
    <parent link="l1"/><child link="l2"/>
    <origin xyz="0.4 0 -0.1" rpy="-1.1 0.4 0.0"/><axis xyz="1 0 0"/>
    <limit lower="-1" upper="1.2"/>
  </joint>
  <joint name="c" type="prismatic">
    <parent link="l1"/><child link="l3"/>
    <origin xyz="0 0.3 0" rpy="0 0 1.57"/><axis xyz="0 0 1"/>
    <limit lower="-0.2" upper="0.4"/>
  </joint>
  <joint name="d" type="revolute">
    <parent link="l2"/><child link="l4"/>
    <origin xyz="0.2 0.1 0"/><axis xyz="0 0 1"/>
    <limit lower="-2" upper="2"/>
    <mimic joint="b" multiplier="-1.5" offset="0.2"/>
  </joint>
</robot>"""


def test_parse_urdf():
    for xml in (ARM, MIMIC, TILTED):
        got, want = turdf.parse_urdf(xml), jurdf.parse_urdf(xml)
        for f in ("name", "link_names", "num_dofs", "actuated_names"):
            assert getattr(got, f) == getattr(want, f), f
        for f in ("parent_link_idx", "child_link_idx", "lower_limits",
                  "upper_limits"):
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(want, f), f)
        for gj, wj in zip(got.joints, want.joints):
            for f in ("name", "jtype", "parent", "child", "lower", "upper",
                      "act_idx", "mimic_idx", "mimic_mult", "mimic_off"):
                assert getattr(gj, f) == getattr(wj, f), (wj.name, f)
            np.testing.assert_array_equal(gj.origin_xyz, wj.origin_xyz)
            np.testing.assert_array_equal(gj.axis, wj.axis)
            _close(gj.origin_quat, wj.origin_quat, 1e-7, wj.name)
    with pytest.raises(ValueError):
        turdf.parse_urdf("<mujoco/>")


def test_urdf_fk():
    rng = np.random.default_rng(0)
    for xml in (ARM, MIMIC, TILTED):
        robot = turdf.parse_urdf(xml)
        jrobot = jurdf.parse_urdf(xml)
        q = rng.uniform(-1, 1, (6, robot.num_dofs)).astype(np.float32)
        rp = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
        rq = rng.standard_normal((6, 4)).astype(np.float32)
        rq /= np.linalg.norm(rq, axis=-1, keepdims=True)
        for args in ((), (rp, rq)):
            want = jurdf.forward_kinematics(jrobot, jnp.asarray(q),
                                            *map(jnp.asarray, args))
            got = turdf.forward_kinematics(robot, _t(q), *map(_t, args))
            for g, w, what in zip(got, want, ("pos", "quat")):
                _close(g, w, 1e-5, f"{robot.name} {what}")


def test_humanoid_keypoints_and_mapping():
    jm, tm = jspec().build(), tspec().build(device="cpu")
    kp, bi = tik._mapping_indices(tm, tik.DEFAULT_SMPL_TO_HUMANOID,
                                  tik.SMPL_JOINT_NAMES)
    wkp, wbi = jik._mapping_indices(jm, jik.DEFAULT_SMPL_TO_HUMANOID,
                                    jik.SMPL_JOINT_NAMES)
    np.testing.assert_array_equal(kp, wkp)
    np.testing.assert_array_equal(bi, wbi)
    assert tik.SMPL_JOINT_NAMES == jik.SMPL_JOINT_NAMES
    frames = np.asarray(walking_clip(seed=0, n=12).frames)
    _close(tik.keypoints_from_motion(tm, frames),
           jik.keypoints_from_motion(jm, frames), 1e-5, "keypoints")


def test_humanoid_ik_five_iterations():
    """SMPL-named keypoints of a walking clip (the default mapping, scale
    optimized) retargeted back onto the humanoid for 5 Adam iterations."""
    jm, tm = jspec().build(), tspec().build(device="cpu")
    frames = np.asarray(walking_clip(seed=0, n=8).frames)
    body = jik.keypoints_from_motion(jm, frames)
    names = list(jik.SMPL_JOINT_NAMES)
    kps = np.zeros((8, len(names), 3), np.float32)
    for smpl, b in jik.DEFAULT_SMPL_TO_HUMANOID.items():
        kps[:, names.index(smpl)] = body[:, jm.body_names.index(b)]
    kps += np.random.default_rng(1).normal(0, 0.01, kps.shape)
    cfg_j, cfg_t = jik.RetargetConfig(iters=5), tik.RetargetConfig(iters=5)
    want, wl = jik.retarget_keypoints(jm, kps, cfg=cfg_j)
    got, gl = tik.retarget_keypoints(tm, kps, cfg=cfg_t, device="cpu")
    assert got.shape == want.shape == (8, 34)
    _close(got, want, 2 * LR, "frames")
    assert set(gl) == set(wl)
    total = sum(wl.values())
    for k in wl:
        assert abs(gl[k] - wl[k]) <= 1e-3 * total, (k, gl[k], wl[k])


def test_urdf_ik_five_iterations():
    robot, jrobot = turdf.parse_urdf(ARM), jurdf.parse_urdf(ARM)
    mapping = {"pelvis": "base", "left_hip": "upper", "left_knee": "fore",
               "left_ankle": "hand", "left_foot": "tool"}
    rng = np.random.default_rng(2)
    q = rng.uniform(-0.5, 0.5, (8, 3)).astype(np.float32)
    pos, _ = jurdf.forward_kinematics(jrobot, jnp.asarray(q))
    names = list(jik.SMPL_JOINT_NAMES)
    kps = rng.normal(0, 0.01, (8, len(names), 3)).astype(np.float32)
    for smpl, link in mapping.items():
        kps[:, names.index(smpl)] += np.asarray(pos)[:, jrobot.link_index(link)]
    want = jurdf.retarget_keypoints_to_robot(
        jrobot, kps, mapping, cfg=jurdf.UrdfRetargetConfig(iters=5))
    got = turdf.retarget_keypoints_to_robot(
        robot, kps, mapping, cfg=turdf.UrdfRetargetConfig(iters=5),
        device="cpu")
    for g, w, what in zip(got[:3], want[:3], ("root_pos", "root_quat", "q")):
        _close(g, w, 2 * LR, what)
    total = sum(want[3].values())
    for k in want[3]:
        assert abs(got[3][k] - want[3][k]) <= 1e-3 * total, k
