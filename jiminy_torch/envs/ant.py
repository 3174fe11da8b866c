"""Ant locomotion env (port of `jiminy_tpu.envs.ant`): the reference's
`ant.urdf` + `ant_hardware.toml` (8 motors, sphere collision bodies on the
torso and the four feet); `procedural=True` takes the parametric look-alike
(`builders.build_ant`) instead."""

from __future__ import annotations

import numpy as np

from jiminy_torch.envs import assets, builders
from jiminy_torch.envs.locomotion import WalkerEnv


class AntEnv(WalkerEnv):
    def __init__(self, step_dt: float = 0.05, horizon: int = 1000,
                 procedural: bool = False, **kw):
        if procedural:
            robot = builders.build_ant()
            q = np.zeros(robot.model.nq)
            q[2] = 0.55  # the torso's height
            q[6] = 1.0
            for leg in ("fl", "fr", "bl", "br"):  # the legs slightly bent
                q[robot.model.idx_q[robot.model.joint_index(f"knee_{leg}")]] = 0.9
        else:
            robot = assets.load_robot("ant")
            # Reference `AntJiminyEnv._neutral` (ant.py:88-104): statically
            # stable stance, all four legs in the same configuration.
            q = np.asarray(robot.model.neutral(), float).copy()
            q[2] = 0.75
            for name, val in (("ankle_1", 1.0), ("ankle_2", -1.0),
                              ("ankle_3", -1.0), ("ankle_4", 1.0)):
                j = robot.model.joint_index(name)
                q[robot.model.idx_q[j]] = val
        kw.setdefault("base_height_min", 0.26)
        kw.setdefault("target_velocity", 1.0)
        super().__init__(robot, q, step_dt=step_dt, horizon=horizon, **kw)
