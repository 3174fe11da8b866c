"""Nominal poses of the packaged robots (port of `jiminy_tpu.envs.builders`,
`anymal_standing_pose`). The procedural look-alike builders are not ported
yet (ROADMAP.md queue 1 item 8)."""

from __future__ import annotations

import numpy as np

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
