"""Reference-derived PD gains of the bipeds (port of
`jiminy_tpu.envs.builders_bipeds`, the Atlas table and `pd_gains`). The
procedural look-alike builders are not ported yet (ROADMAP.md queue 1
item 10)."""

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


def pd_gains(robot, table):
    """Per-motor (kp, kd) arrays on the motor side from an effective
    joint-side gain table, matched by the first key contained in the motor's
    name: kp_m = kp_eff / reduction^2 (the PD acts on motor-side encoder
    errors and outputs motor-side efforts); kd, a time constant, as is. A
    motor the table does not name raises."""
    kp, kd = [], []
    red = np.asarray(robot.motors.mechanical_reduction)
    for i, name in enumerate(robot.motors.names):
        key = next((k for k in table if k in name), None)
        if key is None:
            raise KeyError(f"no PD gains for motor {name!r}")
        kpe, kdi = table[key]
        kp.append(kpe / float(red[i]) ** 2)
        kd.append(kdi)
    return np.asarray(kp), np.asarray(kd)
