"""Procedural robot builders and nominal poses of the packaged robots (port
of `jiminy_tpu.envs.builders`: the toys, the ant, the ANYmal and
`anymal_standing_pose`).

The builders re-create the robots parametrically (no asset file), handy for
randomizing link geometry; the toy envs take them with `procedural=True`,
the ant env with `procedural=True`, the ANYmal env with `procedural=True` or
`flexible=True`; the bipeds' look-alikes are in `builders_bipeds`.
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


def build_anymal(flexible: bool = False) -> Robot:
    """An ANYmal-class 12-dof quadruped: a free-flyer base and per leg HAA
    (hip abduction, x), HFE (hip flexion, y) and KFE (knee flexion, y); the
    IMU on the base, contact points, contact and force sensors at the feet;
    gear ratio 50, rotor armature, 40 N m / 7.5 rad/s actuators. With
    `flexible`, a spherical flexibility joint (stiffness 1e4, damping 1e2,
    inertia 1e-3) before each KFE."""
    base_m = 16.0
    base_dims = (0.53, 0.30, 0.24)
    hip_m, thigh_m, shank_m = 1.4, 1.1, 0.3
    thigh_l, shank_l = 0.25, 0.33
    x_off, y_off = 0.36, 0.21

    joint_specs = [{"name": "root_joint", "type": JointType.FREE, "parent": -1, "mass": base_m,
                    "com": np.zeros(3), "inertia": _box_inertia(base_m, *base_dims)}]
    frame_specs = [{"name": "base", "parent": 0, "placement": (np.eye(3), np.zeros(3))}]
    contact_frames = []
    limits = dict(effort_limit=40.0, velocity_limit=7.5)
    for leg in ANYMAL_LEGS:
        sx = 1.0 if leg[1] == "F" else -1.0
        sy = 1.0 if leg[0] == "L" else -1.0
        haa_idx = len(joint_specs)
        joint_specs.append({
            "name": f"{leg}_HAA", "type": JointType.REVOLUTE, "parent": 0,
            "placement": (np.eye(3), np.array([sx * x_off, sy * y_off, 0.0])),
            "axis": np.array([1.0, 0.0, 0.0]), "mass": hip_m,
            "com": np.array([0.0, sy * 0.04, 0.0]), "inertia": np.eye(3) * 2e-3,
            "position_limit": (np.array([-0.72]), np.array([0.72])), **limits,
        })
        hfe_idx = len(joint_specs)
        joint_specs.append({
            "name": f"{leg}_HFE", "type": JointType.REVOLUTE, "parent": haa_idx,
            "placement": (np.eye(3), np.array([0.0, sy * 0.08, 0.0])),
            "axis": np.array([0.0, 1.0, 0.0]), "mass": thigh_m,
            "com": np.array([0.0, 0.0, -thigh_l / 2]), "inertia": _rod_inertia(thigh_m, thigh_l),
            "position_limit": (np.array([-3.0]), np.array([3.0])), **limits,
        })
        kfe_idx = len(joint_specs)
        joint_specs.append({
            "name": f"{leg}_KFE", "type": JointType.REVOLUTE, "parent": hfe_idx,
            "placement": (np.eye(3), np.array([0.0, 0.0, -thigh_l])),
            "axis": np.array([0.0, 1.0, 0.0]), "mass": shank_m,
            "com": np.array([0.0, 0.0, -shank_l / 2]), "inertia": _rod_inertia(shank_m, shank_l),
            "position_limit": (np.array([-3.0]), np.array([3.0])), **limits,
        })
        foot = f"{leg}_FOOT"
        frame_specs.append({"name": foot, "parent": kfe_idx,
                            "placement": (np.eye(3), np.array([0.0, 0.0, -shank_l]))})
        contact_frames.append(foot)

    model = build_model("anymal", joint_specs, frame_specs)
    motor_names = [f"{leg}_{j}" for leg in ANYMAL_LEGS for j in ("HAA", "HFE", "KFE")]
    motors = [
        {"joint_name": n, "mechanical_reduction": 50.0,
         "armature": 1.0e-4,  # rotor inertia; joint side 1e-4 * 50^2 = 0.25
         "effort_limit": 40.0 / 50.0, "velocity_limit": 7.5 * 50.0}
        for n in motor_names
    ]
    flexibility = [
        {"joint_name": f"{leg}_KFE", "stiffness": 1.0e4, "damping": 1.0e2, "inertia": 1.0e-3}
        for leg in ANYMAL_LEGS
    ] if flexible else []
    return Robot.build(
        model,
        motors=motors,
        sensors={
            "encoder": [{"motor_name": n} for n in motor_names],
            "effort": [{"motor_name": n} for n in motor_names],
            "imu": [{"frame_name": "base"}],
            "force": [{"frame_name": f"{leg}_FOOT"} for leg in ANYMAL_LEGS],
            "contact": [{"frame_name": f"{leg}_FOOT"} for leg in ANYMAL_LEGS],
        },
        contact_frames=contact_frames,
        flexibility=flexibility,
    )


def _box_inertia(m, lx, ly, lz):
    return np.diag([m / 12.0 * (ly**2 + lz**2), m / 12.0 * (lx**2 + lz**2),
                    m / 12.0 * (lx**2 + ly**2)])


def _rod_inertia(m, length, axis=2):
    """A thin rod along `axis`, about its center."""
    i = m * length**2 / 12.0
    diag = [i, i, i]
    diag[axis] = 1e-6 * m
    return np.diag(diag)


def build_ant() -> Robot:
    """A MuJoCo-style ant: a free-flyer torso and 4 legs of a hip (z) and a
    knee (horizontal, across the leg), 8 actuated dofs, point contacts at
    the 4 feet (reference `ant.py`)."""
    torso_m = 10.0
    hip_r = 0.2
    thigh_l, shank_l = 0.2, 0.4
    leg_m = 1.0
    joint_specs = [
        {
            "name": "root_joint",
            "type": JointType.FREE,
            "parent": -1,
            "mass": torso_m,
            "com": np.zeros(3),
            "inertia": np.eye(3) * torso_m * 0.02,
        }
    ]
    frame_specs = []
    dirs = {
        "fl": np.array([1.0, 1.0, 0.0]) / np.sqrt(2),
        "fr": np.array([1.0, -1.0, 0.0]) / np.sqrt(2),
        "bl": np.array([-1.0, 1.0, 0.0]) / np.sqrt(2),
        "br": np.array([-1.0, -1.0, 0.0]) / np.sqrt(2),
    }
    contact_frames = []
    for leg, d in dirs.items():
        hip_pos = hip_r * d
        # Hip: rotate about z
        hip_idx = len(joint_specs)
        joint_specs.append(
            {
                "name": f"hip_{leg}",
                "type": JointType.REVOLUTE,
                "parent": 0,
                "placement": (np.eye(3), hip_pos),
                "axis": np.array([0.0, 0.0, 1.0]),
                "mass": leg_m / 2,
                "com": d * thigh_l / 2,
                "inertia": np.eye(3) * 1e-3,
                "position_limit": (np.array([-0.6]), np.array([0.6])),
                "effort_limit": 30.0,
                "velocity_limit": 30.0,
            }
        )
        # Knee: rotate about the horizontal axis orthogonal to the leg direction
        axis_knee = np.cross(np.array([0.0, 0.0, 1.0]), d)
        knee_idx = len(joint_specs)
        joint_specs.append(
            {
                "name": f"knee_{leg}",
                "type": JointType.REVOLUTE,
                "parent": hip_idx,
                "placement": (np.eye(3), d * thigh_l),
                "axis": axis_knee,
                "mass": leg_m / 2,
                "com": d * shank_l / 2 - np.array([0, 0, 0.1]),
                "inertia": np.eye(3) * 1e-3,
                "position_limit": (np.array([0.5]), np.array([1.4])),
                "effort_limit": 30.0,
                "velocity_limit": 30.0,
            }
        )
        foot = f"foot_{leg}"
        frame_specs.append(
            {
                "name": foot,
                "parent": knee_idx,
                "placement": (np.eye(3), d * shank_l - np.array([0, 0, 0.2])),
            }
        )
        contact_frames.append(foot)
    frame_specs.append({"name": "torso", "parent": 0, "placement": (np.eye(3), np.zeros(3))})
    model = build_model("ant", joint_specs, frame_specs)
    motors = [
        {"joint_name": f"{j}_{leg}", "effort_limit": 30.0}
        for leg in dirs
        for j in ("hip", "knee")
    ]
    return Robot.build(
        model,
        motors=motors,
        sensors={
            "encoder": [{"motor_name": f"{j}_{leg}"} for leg in dirs for j in ("hip", "knee")],
            "imu": [{"frame_name": "torso"}],
            "contact": [{"frame_name": f"foot_{leg}"} for leg in dirs],
        },
        contact_frames=contact_frames,
    )


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
