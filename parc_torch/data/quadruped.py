"""A quadruped character (an A1-class robot dog), declared as data.

13 bodies, 12 actuated DoF: per leg a hip-roll hinge, a hip-pitch hinge and
a knee hinge. It shows that the physics, the envs and the control-step
kernel take any MJCF-style tree, not only the humanoid. Hinge-only
characters are driven in the ``pd_1d`` control mode, the reference's
per-dof linear PD (envs/ig_char_env.py:412-421).
"""

from __future__ import annotations

import math

import numpy as np

from parc_torch.anim.char_model import (
    BodySpec,
    CharModelSpec,
    GeomSpec,
    JointSpec,
)

_D2R = math.pi / 180.0


def _hinge(name, axis, range_deg, stiffness=80.0, damping=2.0,
           armature=0.01, gear=33.5):
    lo, hi = range_deg
    return JointSpec(name=name, joint_type="hinge", axis=axis,
                     limits=[(lo * _D2R, hi * _D2R)], stiffness=stiffness,
                     damping=damping, armature=armature, gears=[gear])


def quadruped_spec() -> CharModelSpec:
    """12-DoF quadruped (trunk + 4 x (hip_roll, hip_pitch, knee))."""
    bodies = [
        BodySpec(
            name="trunk", parent=-1, pos=(0, 0, 0),
            joint=JointSpec(name="root", joint_type="root"),
            geoms=[GeomSpec("box", pos=(0, 0, 0),
                            size=(0.13, 0.0965, 0.057), density=1100.0)],
        ),
    ]
    legs = {"fr": (0.183, -0.047), "fl": (0.183, 0.047),
            "rr": (-0.183, -0.047), "rl": (-0.183, 0.047)}
    for leg, (x, y) in legs.items():
        sy = -1.0 if y < 0 else 1.0
        hip = len(bodies)
        bodies.append(BodySpec(
            name=f"{leg}_hip", parent=0, pos=(x, y, 0),
            joint=_hinge(f"{leg}_hip_roll", (1, 0, 0), (-46, 46)),
            geoms=[GeomSpec("sphere", pos=(0, sy * 0.04, 0),
                            size=(0.046,), density=900.0)],
        ))
        thigh = len(bodies)
        bodies.append(BodySpec(
            name=f"{leg}_thigh", parent=hip, pos=(0, sy * 0.08, 0),
            joint=_hinge(f"{leg}_hip_pitch", (0, 1, 0), (-60, 240)),
            geoms=[GeomSpec("capsule", fromto=(0, 0, 0, 0, 0, -0.2),
                            size=(0.025,), density=1000.0)],
        ))
        bodies.append(BodySpec(
            name=f"{leg}_calf", parent=thigh, pos=(0, 0, -0.2),
            joint=_hinge(f"{leg}_knee", (0, 1, 0), (-154, -30)),
            geoms=[GeomSpec("capsule", fromto=(0, 0, 0, 0, 0, -0.2),
                            size=(0.02,), density=1000.0)],
        ))
    return CharModelSpec(name="quadruped", bodies=bodies)


def standing_pose_dof() -> np.ndarray:
    """Nominal standing joint angles (hip pitch 0.8 rad, knee -1.6 rad)."""
    dof = np.zeros(12, np.float32)
    for i in range(4):
        dof[i * 3 + 1] = 0.8    # hip pitch
        dof[i * 3 + 2] = -1.6   # knee
    return dof
