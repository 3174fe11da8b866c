"""Procedural biped and humanoid look-alikes and the bipeds' PD gains (port
of `jiminy_tpu.envs.builders_bipeds`).

`build_cassie`, `build_digit` and `build_atlas` re-create the reference's
packaged robots from public spec-level parameters, no asset file: Cassie
and Digit with the pushrod loop closures as distance constraints (reference
`cassie.py:67-140`), the Atlas as the ~30-dof humanoid of the reference's
pipeline benchmark (`reduced`: no arms, no neck). The bipeds' envs take
them with `procedural=True`. The tables and `pd_gains` convert the
reference's tuned gains to the motor side.
"""

from __future__ import annotations

import numpy as np

from jiminy_torch.engine.robot import Robot
from jiminy_torch.envs.builders import _box_inertia, _rod_inertia
from jiminy_torch.models.joints import JointType
from jiminy_torch.models.model import build_model

_REV = JointType.REVOLUTE
_X = np.array([1.0, 0.0, 0.0])
_Y = np.array([0.0, 1.0, 0.0])
_Z = np.array([0.0, 0.0, 1.0])


def _leg_cassie(joint_specs, frame_specs, parent, side, y_off):
    """One Cassie-class leg: hip roll/yaw/pitch + knee + passive tarsus + toe,
    pushrod loop frames on thigh and tarsus."""
    sy = 1.0 if side == "l" else -1.0
    thigh_l, shin_l, tarsus_l = 0.12, 0.435, 0.408

    def add(name, parent, pos, axis, mass, com, inertia, lim, eff=80.0, vel=12.0,
            damping=0.1):
        joint_specs.append(
            {
                "name": name,
                "type": _REV,
                "parent": parent,
                "placement": (np.eye(3), np.asarray(pos, float)),
                "axis": axis,
                "mass": mass,
                "com": np.asarray(com, float),
                "inertia": inertia,
                "damping": damping,
                "position_limit": (np.array([lim[0]]), np.array([lim[1]])),
                "effort_limit": eff,
                "velocity_limit": vel,
            }
        )
        return len(joint_specs) - 1

    hip_roll = add(f"hip_abduction_{side}", parent, [0.021, sy * y_off, 0.0], _X,
                   1.82, [0, sy * 0.02, 0], np.eye(3) * 4e-3, (-0.26, 0.39))
    hip_yaw = add(f"hip_rotation_{side}", hip_roll, [0.0, sy * 0.09, 0.0], _Z,
                  1.17, [0, 0, -0.04], np.eye(3) * 3e-3, (-0.39, 0.39))
    hip_pitch = add(f"hip_flexion_{side}", hip_yaw, [0.0, 0.0, -0.09], _Y,
                    5.52, [0.05, 0, -thigh_l / 2], _rod_inertia(5.52, 0.3), (-0.87, 1.4))
    knee = add(f"knee_joint_{side}", hip_pitch, [0.12, 0.0, -thigh_l], _Y,
               0.76, [0.05, 0, -shin_l / 2], _rod_inertia(0.76, shin_l), (-2.86, -0.64))
    tarsus = add(f"tarsus_joint_{side}", knee, [0.06, 0.0, -shin_l], _Y,
                 0.78, [0.1, 0, -tarsus_l / 2], _rod_inertia(0.78, tarsus_l),
                 (0.65, 2.97), eff=0.0, damping=1.0)
    toe = add(f"toe_joint_{side}", tarsus, [0.2, 0.0, -tarsus_l], _Y,
              0.15, [0.02, 0, -0.01], np.eye(3) * 2e-4, (-2.44, -0.52), eff=30.0)

    # Pushrod attachment frames (closed kinematic loop)
    frame_specs.append(
        {"name": f"pushrod_hip_{side}", "parent": hip_pitch,
         "placement": (np.eye(3), np.array([0.0, sy * 0.02, -0.045]))}
    )
    frame_specs.append(
        {"name": f"pushrod_tarsus_{side}", "parent": tarsus,
         "placement": (np.eye(3), np.array([0.1, sy * 0.02, -0.03]))}
    )
    # Foot contact points (front/back of toe plate)
    for tag, dx in (("front", 0.09), ("back", -0.05)):
        frame_specs.append(
            {"name": f"toe_{side}_{tag}", "parent": toe,
             "placement": (np.eye(3), np.array([dx, 0.0, -0.05]))}
        )
    return [f"hip_abduction_{side}", f"hip_rotation_{side}", f"hip_flexion_{side}",
            f"knee_joint_{side}", f"toe_joint_{side}"]


def build_cassie() -> Robot:
    """Cassie-class biped: 14 joints (10 actuated), pushrod loop closures,
    4 toe contact points (reference `CassieJiminyEnv`)."""
    joint_specs = [
        {
            "name": "root_joint",
            "type": JointType.FREE,
            "parent": -1,
            "mass": 10.33,
            "com": np.array([0.05, 0.0, 0.04]),
            "inertia": _box_inertia(10.33, 0.3, 0.25, 0.2),
        }
    ]
    frame_specs = [{"name": "pelvis", "parent": 0, "placement": (np.eye(3), np.zeros(3))}]
    motors_l = _leg_cassie(joint_specs, frame_specs, 0, "l", 0.135)
    motors_r = _leg_cassie(joint_specs, frame_specs, 0, "r", 0.135)
    model = build_model("cassie", joint_specs, frame_specs)
    motor_names = motors_l + motors_r
    contact = [f"toe_{s}_{t}" for s in ("l", "r") for t in ("front", "back")]
    return Robot.build(
        model,
        motors=[{"joint_name": n, "mechanical_reduction": 25.0,
                 "armature": 3.0e-4} for n in motor_names],
        sensors={
            "encoder": [{"motor_name": n} for n in motor_names],
            "effort": [{"motor_name": n} for n in motor_names],
            "imu": [{"frame_name": "pelvis"}],
            "contact": [{"frame_name": f} for f in contact],
        },
        contact_frames=contact,
        loop_constraints=[
            ("pushrod_hip_l", "pushrod_tarsus_l"),
            ("pushrod_hip_r", "pushrod_tarsus_r"),
        ],
    )


def build_digit() -> Robot:
    """Digit-class biped: Cassie-style legs + 4-dof arms (reference
    `DigitJiminyEnv`)."""
    joint_specs = [
        {
            "name": "root_joint",
            "type": JointType.FREE,
            "parent": -1,
            "mass": 15.0,
            "com": np.array([0.0, 0.0, 0.1]),
            "inertia": _box_inertia(15.0, 0.35, 0.3, 0.5),
        }
    ]
    frame_specs = [{"name": "torso", "parent": 0, "placement": (np.eye(3), np.zeros(3))}]
    motors = _leg_cassie(joint_specs, frame_specs, 0, "l", 0.15)
    motors += _leg_cassie(joint_specs, frame_specs, 0, "r", 0.15)

    for side in ("l", "r"):
        sy = 1.0 if side == "l" else -1.0
        parent = 0
        arm_chain = [
            (f"shoulder_roll_{side}", _X, [0.0, sy * 0.22, 0.4], (-1.3, 1.3)),
            (f"shoulder_pitch_{side}", _Y, [0.0, sy * 0.06, 0.0], (-2.5, 2.5)),
            (f"shoulder_yaw_{side}", _Z, [0.0, 0.0, -0.16], (-1.7, 1.7)),
            (f"elbow_{side}", _Y, [0.0, 0.0, -0.18], (-1.35, 1.35)),
        ]
        for name, axis, pos, lim in arm_chain:
            joint_specs.append(
                {
                    "name": name,
                    "type": _REV,
                    "parent": parent,
                    "placement": (np.eye(3), np.asarray(pos, float)),
                    "axis": axis,
                    "mass": 0.8,
                    "com": np.array([0.0, 0.0, -0.08]),
                    "inertia": np.eye(3) * 2e-3,
                    "position_limit": (np.array([lim[0]]), np.array([lim[1]])),
                    "effort_limit": 30.0,
                    "velocity_limit": 10.0,
                }
            )
            parent = len(joint_specs) - 1
            motors.append(name)

    model = build_model("digit", joint_specs, frame_specs)
    contact = [f"toe_{s}_{t}" for s in ("l", "r") for t in ("front", "back")]
    return Robot.build(
        model,
        motors=[{"joint_name": n, "mechanical_reduction": 25.0,
                 "armature": 3.0e-4} for n in motors],
        sensors={
            "encoder": [{"motor_name": n} for n in motors],
            "imu": [{"frame_name": "torso"}],
            "contact": [{"frame_name": f} for f in contact],
        },
        contact_frames=contact,
        loop_constraints=[
            ("pushrod_hip_l", "pushrod_tarsus_l"),
            ("pushrod_hip_r", "pushrod_tarsus_r"),
        ],
    )


# --------------------------------------------------------------------------- #
# Atlas-class humanoid
# --------------------------------------------------------------------------- #


def build_atlas(reduced: bool = False) -> Robot:
    """Atlas-class ~30-dof humanoid: 6-dof legs, 3-dof back, 7-dof arms, neck
    (reference `AtlasJiminyEnv` / `AtlasReducedJiminyEnv` with fixed arms)."""
    joint_specs = [
        {
            "name": "root_joint",
            "type": JointType.FREE,
            "parent": -1,
            "mass": 17.0,
            "com": np.array([0.0, 0.0, 0.0]),
            "inertia": _box_inertia(17.0, 0.35, 0.35, 0.3),
        }
    ]
    frame_specs = [
        {"name": "pelvis", "parent": 0, "placement": (np.eye(3), np.zeros(3))}
    ]

    def add(name, parent, pos, axis, mass, com, lim, eff=200.0, vel=12.0,
            inertia_scale=0.01):
        joint_specs.append(
            {
                "name": name,
                "type": _REV,
                "parent": parent,
                "placement": (np.eye(3), np.asarray(pos, float)),
                "axis": axis,
                "mass": mass,
                "com": np.asarray(com, float),
                "inertia": np.eye(3) * inertia_scale * mass,
                "position_limit": (np.array([lim[0]]), np.array([lim[1]])),
                "effort_limit": eff,
                "velocity_limit": vel,
            }
        )
        return len(joint_specs) - 1

    motors = []
    # Back (3 dof) + neck
    bkz = add("back_bkz", 0, [-0.01, 0.0, 0.09], _Z, 9.6, [0, 0, 0.15], (-0.66, 0.66))
    bky = add("back_bky", bkz, [0.0, 0.0, 0.16], _Y, 16.0, [0, 0, 0.2], (-0.22, 0.54))
    bkx = add("back_bkx", bky, [0.0, 0.0, 0.05], _X, 30.0, [0, 0, 0.3], (-0.52, 0.52))
    motors += ["back_bkz", "back_bky", "back_bkx"]
    if not reduced:
        add("neck_ry", bkx, [0.0, 0.0, 0.6], _Y, 1.5, [0, 0, 0.1], (-0.6, 1.1), eff=25.0)
        motors.append("neck_ry")

    # Legs (6 dof each)
    for side, sy in (("l", 1.0), ("r", -1.0)):
        hpz = add(f"{side}_leg_hpz", 0, [0.0, sy * 0.089, 0.0], _Z, 2.5,
                  [0, 0, -0.04], (-0.79, 0.79), eff=110.0)
        hpx = add(f"{side}_leg_hpx", hpz, [0.0, 0.0, -0.05], _X, 2.0,
                  [0, sy * 0.02, -0.03], (-0.52, 0.52), eff=180.0)
        hpy = add(f"{side}_leg_hpy", hpx, [0.05, sy * 0.023, -0.066], _Y, 7.3,
                  [0, 0, -0.21], (-1.61, 0.65), eff=260.0)
        kny = add(f"{side}_leg_kny", hpy, [-0.05, 0.0, -0.37], _Y, 5.0,
                  [0, 0, -0.19], (0.0, 2.35), eff=220.0)
        aky = add(f"{side}_leg_aky", kny, [0.0, 0.0, -0.42], _Y, 2.5,
                  [0.02, 0, -0.03], (-1.0, 0.7), eff=700.0, vel=9.0)
        akx = add(f"{side}_leg_akx", aky, [0.0, 0.0, -0.07], _X, 1.2,
                  [0.02, 0, -0.01], (-0.8, 0.8), eff=360.0)
        motors += [f"{side}_leg_{j}" for j in ("hpz", "hpx", "hpy", "kny", "aky", "akx")]
        # 4 contact corners per foot
        for tag, (dx, dy) in (("fl", (0.17, 0.06)), ("fr", (0.17, -0.06)),
                              ("bl", (-0.07, 0.06)), ("br", (-0.07, -0.06))):
            frame_specs.append(
                {"name": f"{side}_foot_{tag}", "parent": akx,
                 "placement": (np.eye(3), np.array([dx, dy, -0.035]))}
            )

    # Arms (7 dof each) unless reduced
    if not reduced:
        for side, sy in (("l", 1.0), ("r", -1.0)):
            parent = bkx
            arm = [
                (f"{side}_arm_shz", _Z, [0.1, sy * 0.22, 0.4], (-1.6, 1.6), 4.0),
                (f"{side}_arm_shx", _X, [0.0, sy * 0.11, -0.01], (-1.6, 1.6), 4.5),
                (f"{side}_arm_ely", _Y, [0.0, sy * 0.19, 0.0], (0.0, 3.14), 3.6),
                # elx limits mirror between sides (right elbow bends negative,
                # as in the reference Atlas URDF)
                (f"{side}_arm_elx", _X, [0.0, sy * 0.12, 0.0],
                 (0.0, 2.36) if side == "l" else (-2.36, 0.0), 3.2),
                (f"{side}_arm_wry", _Y, [0.0, sy * 0.19, 0.0], (-3.0, 3.0), 2.3),
                (f"{side}_arm_wrx", _X, [0.0, sy * 0.12, 0.0], (-1.2, 1.2), 1.8),
                (f"{side}_arm_wry2", _Y, [0.0, sy * 0.06, 0.0], (-0.0001, 0.0001), 0.5),
            ]
            for name, axis, pos, lim, mass in arm:
                parent = add(name, parent, pos, axis, mass,
                             [0, sy * 0.06, 0], lim, eff=90.0, vel=10.0)
                motors.append(name)

    model = build_model("atlas", joint_specs, frame_specs)
    contact = [f"{s}_foot_{t}" for s in ("l", "r") for t in ("fl", "fr", "bl", "br")]
    return Robot.build(
        model,
        motors=[{"joint_name": n, "armature": 6e-3, "mechanical_reduction": 10.0}  # joint-side 0.6, ref atlas_hardware.toml
                for n in motors],
        sensors={
            "encoder": [{"motor_name": n} for n in motors],
            "effort": [{"motor_name": n} for n in motors],
            "imu": [{"frame_name": "pelvis"}],
            "force": [{"frame_name": f"{s}_foot_fl"} for s in ("l", "r")],
            "contact": [{"frame_name": f} for f in contact],
        },
        contact_frames=contact,
    )


def atlas_standing_pose(model) -> np.ndarray:
    q = np.zeros(model.nq)
    q[2] = 0.95
    q[6] = 1.0

    def set_j(name, val):
        if name in model.joint_names:
            j = model.joint_index(name)
            q[model.idx_q[j]] = val

    for side in ("l", "r"):
        set_j(f"{side}_leg_hpy", -0.25)
        set_j(f"{side}_leg_kny", 0.55)
        set_j(f"{side}_leg_aky", -0.3)
        set_j(f"{side}_arm_shx", -1.3 if side == "l" else 1.3)
        set_j(f"{side}_arm_ely", 1.2)
        set_j(f"{side}_arm_elx", 0.6 if side == "l" else -0.6)
    return q


def cassie_standing_pose(model) -> np.ndarray:
    q = np.zeros(model.nq)
    q[2] = 0.95
    q[6] = 1.0

    def set_j(name, val):
        j = model.joint_index(name)
        q[model.idx_q[j]] = val

    for side in ("l", "r"):
        # Pitches about y sum to zero so the toe plate is level (flat on both
        # contact points), and the angles place the support span directly
        # under the CoM: com_x = +0.055, feet span x in [-0.018, +0.122]
        # (numerically balanced; a pose with feet forward of the CoM cannot
        # stand no matter the PD gains).
        set_j(f"hip_flexion_{side}", 0.55)
        set_j(f"knee_joint_{side}", -1.2)
        set_j(f"tarsus_joint_{side}", 1.95)
        set_j(f"toe_joint_{side}", -1.3)
    return q



# EFFECTIVE joint-side proportional stiffness [N*m/rad] and derivative time
# constant [s] of the reference's tuned Atlas pipeline (`atlas.py
# PD_FULL_KP`, joint side as is). `pd_gains` converts them to the motor side.
ATLAS_PD_EFFECTIVE = {
    "back_bkz": (5000.0, 0.01), "back_bky": (8000.0, 0.015),
    "back_bkx": (5000.0, 0.02), "neck_ry": (100.0, 0.01),
    "leg_hpz": (5000.0, 0.01), "leg_hpx": (5000.0, 0.02),
    "leg_hpy": (8000.0, 0.02), "leg_kny": (4000.0, 0.01),
    "leg_aky": (8000.0, 0.025), "leg_akx": (5000.0, 0.01),
    "arm_shz": (500.0, 0.01), "arm_shx": (100.0, 0.01),
    "arm_ely": (200.0, 0.01), "arm_elx": (500.0, 0.02),
    "arm_wry2": (10.0, 0.02), "arm_wry": (10.0, 0.01), "arm_wrx": (100.0, 0.02),
}


# Cassie and Digit (`cassie.py`/`digit.py` PD_KP are motor side there: the
# effective value is kp * reduction^2 with the hardware files' reductions)
CASSIE_PD_EFFECTIVE = {
    "hip_abduction": (2500.0, 0.02), "hip_rotation": (2500.0, 0.02),
    "hip_flexion": (1600.0, 0.02), "knee_joint": (1600.0, 0.02),
    "toe_joint": (4000.0, 0.015),
}

DIGIT_PD_EFFECTIVE = {
    **CASSIE_PD_EFFECTIVE,
    "shoulder_roll": (4000.0, 0.01), "shoulder_pitch": (4000.0, 0.01),
    "shoulder_yaw": (2500.0, 0.01), "elbow": (4000.0, 0.01),
}

# The gains of a motor the Cassie and Digit tables do not name (Digit's toe
# pitch and roll), jiminy_tpu's default
REFERENCE_DEFAULT_GAINS = (500.0, 0.01)


def pd_gains(robot, table, default=None, kd_min=0.0):
    """Per-motor (kp, kd) arrays on the motor side from an effective
    joint-side gain table, matched by the first key contained in the motor's
    name: kp_m = kp_eff / reduction^2 (the PD acts on motor-side encoder
    errors and outputs motor-side efforts); kd, a time constant, as is, at
    least `kd_min`. A motor the table does not name takes `default` (kp_eff,
    kd), and raises without one."""
    kp, kd = [], []
    red = np.asarray(robot.motors.mechanical_reduction)
    for i, name in enumerate(robot.motors.names):
        key = next((k for k in table if k in name), None)
        if key is None and default is None:
            raise KeyError(f"no PD gains for motor {name!r}")
        kpe, kdi = table[key] if key is not None else default
        kp.append(kpe / float(red[i]) ** 2)
        kd.append(max(kdi, kd_min))
    return np.asarray(kp), np.asarray(kd)
