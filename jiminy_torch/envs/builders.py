"""Procedural robot builders and nominal poses of the packaged robots (port
of `jiminy_tpu.envs.builders`: the toys and `anymal_standing_pose`).

The toy builders re-create the classic-control robots parametrically (no
asset file), handy for randomizing link geometry; the toy envs take them
with `procedural=True`. The other procedural look-alikes are not ported yet
(ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

import numpy as np

from jiminy_torch.engine.robot import Robot
from jiminy_torch.models.joints import JointType
from jiminy_torch.models.model import build_model

ANYMAL_LEGS = ("LF", "RF", "LH", "RH")


def anymal_standing_pose(model) -> np.ndarray:
    """Nominal standing configuration: legs in x-shape, base at the leg
    height (the env then auto-levels the feet onto the ground)."""
    q = np.zeros(model.nq)
    q[2] = 0.533
    q[6] = 1.0  # quaternion w
    for leg in ANYMAL_LEGS:
        sx = 1.0 if leg[1] == "F" else -1.0
        for jname, val in ((f"{leg}_HAA", 0.0), (f"{leg}_HFE", sx * 0.4), (f"{leg}_KFE", -sx * 0.8)):
            q[model.idx_q[model.joint_index(jname)]] = val
    return q


def _box_inertia(m, lx, ly, lz):
    return np.diag([m / 12.0 * (ly**2 + lz**2), m / 12.0 * (lx**2 + lz**2),
                    m / 12.0 * (lx**2 + ly**2)])


def _rod_inertia(m, length, axis=2):
    """A thin rod along `axis`, about its center."""
    i = m * length**2 / 12.0
    diag = [i, i, i]
    diag[axis] = 1e-6 * m
    return np.diag(diag)


def build_cartpole(cart_mass=1.0, pole_mass=0.1, pole_length=0.5, force_max=10.0) -> Robot:
    """A cart on an x-prismatic rail and an unactuated pole."""
    model = build_model(
        "cartpole",
        [
            {
                "name": "slider_to_cart",
                "type": JointType.PRISMATIC,
                "parent": -1,
                "axis": np.array([1.0, 0.0, 0.0]),
                "mass": cart_mass,
                "com": np.zeros(3),
                "inertia": _box_inertia(cart_mass, 0.3, 0.2, 0.1),
                "position_limit": (np.array([-4.8]), np.array([4.8])),
                "velocity_limit": 100.0,
                "effort_limit": 3 * force_max,
            },
            {
                "name": "cart_to_pole",
                "type": JointType.REVOLUTE,
                "parent": 0,
                "axis": np.array([0.0, 1.0, 0.0]),
                "mass": pole_mass,
                "com": np.array([0.0, 0.0, pole_length / 2]),
                "inertia": _rod_inertia(pole_mass, pole_length),
            },
        ],
        [{"name": "pole_tip", "parent": 1,
          "placement": (np.eye(3), np.array([0.0, 0.0, pole_length]))}],
    )
    return Robot.build(
        model,
        motors=[{"joint_name": "slider_to_cart", "effort_limit": force_max}],
        sensors={
            "encoder": [{"joint_name": "slider_to_cart"}, {"joint_name": "cart_to_pole"}],
            "effort": [{"motor_name": "slider_to_cart"}],
        },
    )


def build_acrobot(l1=1.0, l2=1.0, m1=1.0, m2=1.0, torque_max=10.0) -> Robot:
    """A two-link underactuated pendulum, actuated at the elbow."""
    model = build_model(
        "acrobot",
        [
            {
                "name": "shoulder",
                "type": JointType.REVOLUTE,
                "parent": -1,
                "axis": np.array([0.0, 1.0, 0.0]),
                "mass": m1,
                "com": np.array([0.0, 0.0, -l1 / 2]),
                "inertia": _rod_inertia(m1, l1),
            },
            {
                "name": "elbow",
                "type": JointType.REVOLUTE,
                "parent": 0,
                "placement": (np.eye(3), np.array([0.0, 0.0, -l1])),
                "axis": np.array([0.0, 1.0, 0.0]),
                "mass": m2,
                "com": np.array([0.0, 0.0, -l2 / 2]),
                "inertia": _rod_inertia(m2, l2),
            },
        ],
        [{"name": "tip", "parent": 1, "placement": (np.eye(3), np.array([0.0, 0.0, -l2]))}],
    )
    return Robot.build(
        model,
        motors=[{"joint_name": "elbow", "effort_limit": torque_max}],
        sensors={
            "encoder": [{"joint_name": "shoulder"}, {"joint_name": "elbow"}],
            "effort": [{"motor_name": "elbow"}],
        },
    )


def build_pendulum(mass=1.0, length=1.0, torque_max=2.0) -> Robot:
    """A point mass on a massless rod about a y pivot."""
    model = build_model(
        "pendulum",
        [
            {
                "name": "pivot",
                "type": JointType.REVOLUTE,
                "parent": -1,
                "axis": np.array([0.0, 1.0, 0.0]),
                "mass": mass,
                "com": np.array([0.0, 0.0, -length]),
                "inertia": np.zeros((3, 3)),
            }
        ],
        [{"name": "tip", "parent": 0, "placement": (np.eye(3), np.array([0.0, 0.0, -length]))}],
    )
    return Robot.build(
        model,
        motors=[{"joint_name": "pivot", "effort_limit": torque_max}],
        sensors={"encoder": [{"joint_name": "pivot"}]},
    )
