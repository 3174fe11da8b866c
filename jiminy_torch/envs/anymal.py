"""ANYmal quadruped locomotion env (port of `jiminy_tpu.envs.anymal`): the
real-URDF ANYmal from the vendored `anymal.urdf` + `anymal_hardware.toml`,
or with `procedural=True` the parametric look-alike (`builders.build_anymal`),
and with `flexible=True` that look-alike with a spherical flexibility joint
before each knee (its state the extended model's)."""

from __future__ import annotations

import numpy as np

from jiminy_torch.envs import assets, builders
from jiminy_torch.envs.locomotion import WalkerEnv
from jiminy_torch.gym.blocks import PDController
from jiminy_torch.gym.pipeline import ControlledEnv


class ANYmalEnv(WalkerEnv):
    def __init__(self, step_dt: float = 0.04, horizon: int = 500, flexible: bool = False,
                 std_ratio: float = 0.0, procedural: bool = False, **kw):
        if procedural or flexible:
            robot = builders.build_anymal(flexible=flexible)
        else:
            robot = assets.load_robot("anymal")
        nominal_q = (self._flexible_pose(robot) if flexible
                     else builders.anymal_standing_pose(robot.model))
        super().__init__(robot, nominal_q, step_dt=step_dt, horizon=horizon,
                         std_ratio=std_ratio, **kw)

    @staticmethod
    def _flexible_pose(robot) -> np.ndarray:
        """The standing pose of the theoretical model carried joint by joint
        into the extended one, the flexibility quaternions at the identity."""
        th, model = robot.theoretical_model, robot.model
        nominal_q = builders.anymal_standing_pose(th)
        q = np.zeros(model.nq)
        for j in range(th.njoints):
            je = model.joint_index(th.joint_names[j])
            q[model.q_slice(je)] = nominal_q[th.q_slice(j)]
        for j in range(model.njoints):
            if model.joint_names[j].endswith("_flexibility"):
                q[model.idx_q[j] + 3] = 1.0  # identity quaternion
        return q


def ANYmalPDControlEnv(step_dt: float = 0.04, horizon: int = 500, kp=1500.0, kd=0.01, **kw):
    """`-pid` pipeline variant: a PD controller block on motor targets with
    the reference's gains (`anymal.py:27-31`, kp=1500, kd=0.01; the
    procedural look-alike has other reductions: pass explicit gains)."""
    env = ANYmalEnv(step_dt=step_dt, horizon=horizon, **kw)
    return ControlledEnv(env, PDController(kp=kp, kd=kd).setup(env))
