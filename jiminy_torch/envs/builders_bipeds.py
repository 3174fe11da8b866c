"""Reference-derived PD gains of the bipeds (port of
`jiminy_tpu.envs.builders_bipeds`: the Atlas, Cassie and Digit tables and
`pd_gains`). The procedural look-alike builders are not ported yet
(ROADMAP.md queue 1 item 10)."""

from __future__ import annotations

import numpy as np

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
