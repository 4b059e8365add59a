"""The PARC humanoid character, declared as data.

15 bodies, 28 actuated DoF (8 spherical joints stored as 3-DoF exp-maps +
4 one-DoF hinges: elbows and knees), hands fixed.  Numeric values follow the
reference character asset (reference: data/assets/humanoid.xml) so motion
clips are interchangeable; the model representation itself is built fresh for
the port (see parc_torch/anim/char_model.py).

Per-geom densities are kept so rigid-body mass properties for the physics
backend can be derived analytically.
"""

from __future__ import annotations

import math

from reference.anim.char_model import (
    BodySpec,
    CharModelSpec,
    GeomSpec,
    JointSpec,
)

_D2R = math.pi / 180.0


def _sph(name, ranges, stiffness, damping, armature, gears):
    """Spherical joint from three per-axis (x, y, z) hinge ranges (degrees)."""
    limits = [(lo * _D2R, hi * _D2R) for lo, hi in ranges]
    return JointSpec(
        name=name, joint_type="spherical", limits=limits,
        stiffness=stiffness, damping=damping, armature=armature, gears=gears,
    )


def _hinge(name, axis, range_deg, stiffness, damping, armature, gear):
    lo, hi = range_deg
    return JointSpec(
        name=name, joint_type="hinge", axis=axis,
        limits=[(lo * _D2R, hi * _D2R)],
        stiffness=stiffness, damping=damping, armature=armature, gears=[gear],
    )


def humanoid_spec() -> CharModelSpec:
    bodies = [
        BodySpec(
            name="pelvis", parent=-1, pos=(0.0, 0.0, 0.0),
            joint=JointSpec(name="root", joint_type="root"),
            geoms=[
                GeomSpec("sphere", pos=(0, 0, 0.07), size=(0.09,), density=2226.0),
                GeomSpec("sphere", pos=(0, 0, 0.205), size=(0.07,), density=2226.0),
            ],
        ),
        BodySpec(
            name="torso", parent=0, pos=(0.0, 0.0, 0.236151),
            joint=_sph("abdomen", [(-60, 60), (-60, 90), (-70, 70)],
                       1000.0, 100.0, 0.02, [200, 200, 200]),
            geoms=[
                GeomSpec("sphere", pos=(0, 0, 0.12), size=(0.11,), density=1794.0),
                GeomSpec("capsule",
                         fromto=(-0.0060125, -0.0457775, 0.2287955,
                                 -0.016835, -0.128177, 0.2376182),
                         size=(0.045,), density=1100.0),
                GeomSpec("capsule",
                         fromto=(-0.0060125, 0.0457775, 0.2287955,
                                 -0.016835, 0.128177, 0.2376182),
                         size=(0.045,), density=1100.0),
            ],
        ),
        BodySpec(
            name="head", parent=1, pos=(0.0, 0.0, 0.223894),
            joint=_sph("neck", [(-50, 50), (-40, 60), (-45, 45)],
                       100.0, 10.0, 0.01, [50, 50, 50]),
            geoms=[GeomSpec("sphere", pos=(0, 0, 0.175), size=(0.095,), density=1081.0)],
        ),
        BodySpec(
            name="right_upper_arm", parent=1, pos=(-0.02405, -0.18311, 0.24350),
            joint=_sph("right_shoulder", [(-110, 140), (-90, 90), (-60, 160)],
                       400.0, 40.0, 0.02, [100, 100, 100]),
            geoms=[GeomSpec("capsule", fromto=(0, -0.03, 0, 0, -0.23, 0),
                            size=(0.045,), density=982.0)],
        ),
        BodySpec(
            name="right_lower_arm", parent=3, pos=(0.0, -0.274788, 0.0),
            joint=_hinge("right_elbow", (0, 0, 1), (0, 160), 300.0, 30.0, 0.01, 70),
            geoms=[GeomSpec("capsule", fromto=(0, -0.035, 0, 0, -0.1875, 0),
                            size=(0.04,), density=1056.0)],
        ),
        BodySpec(
            name="right_hand", parent=4, pos=(0.0, -0.258947, 0.0),
            joint=JointSpec(name="right_hand", joint_type="fixed"),
            geoms=[GeomSpec("sphere", pos=(0, 0, 0), size=(0.04,), density=1865.0)],
        ),
        BodySpec(
            name="left_upper_arm", parent=1, pos=(-0.02405, 0.18311, 0.24350),
            joint=_sph("left_shoulder", [(-140, 110), (-90, 90), (-160, 60)],
                       400.0, 40.0, 0.02, [100, 100, 100]),
            geoms=[GeomSpec("capsule", fromto=(0, 0.03, 0, 0, 0.23, 0),
                            size=(0.045,), density=982.0)],
        ),
        BodySpec(
            name="left_lower_arm", parent=6, pos=(0.0, 0.274788, 0.0),
            joint=_hinge("left_elbow", (0, 0, 1), (-160, 0), 300.0, 30.0, 0.01, 70),
            geoms=[GeomSpec("capsule", fromto=(0, 0.035, 0, 0, 0.1875, 0),
                            size=(0.04,), density=1056.0)],
        ),
        BodySpec(
            name="left_hand", parent=7, pos=(0.0, 0.258947, 0.0),
            joint=JointSpec(name="left_hand", joint_type="fixed"),
            geoms=[GeomSpec("sphere", pos=(0, 0, 0), size=(0.04,), density=1865.0)],
        ),
        BodySpec(
            name="right_thigh", parent=0, pos=(0.0, -0.084887, 0.0),
            joint=_sph("right_hip", [(-60, 30), (-140, 60), (-60, 60)],
                       500.0, 50.0, 0.02, [200, 200, 200]),
            geoms=[GeomSpec("capsule", fromto=(0, 0, -0.04, 0, 0, -0.36),
                            size=(0.055,), density=1269.0)],
        ),
        BodySpec(
            name="right_shin", parent=9, pos=(0.0, 0.0, -0.421546),
            joint=_hinge("right_knee", (0, 1, 0), (0, 160), 500.0, 50.0, 0.02, 150),
            geoms=[GeomSpec("capsule", fromto=(0, 0, -0.03, 0, 0, -0.355),
                            size=(0.05,), density=1014.0)],
        ),
        BodySpec(
            name="right_foot", parent=10, pos=(0.0, 0.0, -0.409870),
            joint=_sph("right_ankle", [(-30, 30), (-55, 55), (-40, 40)],
                       400.0, 40.0, 0.01, [90, 90, 90]),
            geoms=[GeomSpec("box", pos=(0.045, 0, -0.0225),
                            size=(0.0885, 0.045, 0.0275), density=1141.0)],
        ),
        BodySpec(
            name="left_thigh", parent=0, pos=(0.0, 0.084887, 0.0),
            joint=_sph("left_hip", [(-30, 60), (-140, 60), (-60, 60)],
                       500.0, 50.0, 0.02, [200, 200, 200]),
            geoms=[GeomSpec("capsule", fromto=(0, 0, -0.04, 0, 0, -0.36),
                            size=(0.055,), density=1269.0)],
        ),
        BodySpec(
            name="left_shin", parent=12, pos=(0.0, 0.0, -0.421546),
            joint=_hinge("left_knee", (0, 1, 0), (0, 160), 500.0, 50.0, 0.02, 150),
            geoms=[GeomSpec("capsule", fromto=(0, 0, -0.03, 0, 0, -0.355),
                            size=(0.05,), density=1014.0)],
        ),
        BodySpec(
            name="left_foot", parent=13, pos=(0.0, 0.0, -0.409870),
            joint=_sph("left_ankle", [(-30, 30), (-55, 55), (-40, 40)],
                       400.0, 40.0, 0.01, [90, 90, 90]),
            geoms=[GeomSpec("box", pos=(0.045, 0, -0.0225),
                            size=(0.0885, 0.045, 0.0275), density=1141.0)],
        ),
    ]
    return CharModelSpec(name="humanoid", bodies=bodies)


# Body indices of interest (depth-first order, matching the reference layout).
PELVIS, TORSO, HEAD = 0, 1, 2
RIGHT_UPPER_ARM, RIGHT_LOWER_ARM, RIGHT_HAND = 3, 4, 5
LEFT_UPPER_ARM, LEFT_LOWER_ARM, LEFT_HAND = 6, 7, 8
RIGHT_THIGH, RIGHT_SHIN, RIGHT_FOOT = 9, 10, 11
LEFT_THIGH, LEFT_SHIN, LEFT_FOOT = 12, 13, 14

KEY_BODIES = (RIGHT_HAND, LEFT_HAND, RIGHT_FOOT, LEFT_FOOT)
CONTACT_BODIES = (RIGHT_HAND, LEFT_HAND, RIGHT_FOOT, LEFT_FOOT)
