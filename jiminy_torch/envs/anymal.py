"""ANYmal quadruped locomotion env (port of `jiminy_tpu.envs.anymal`): the
real-URDF ANYmal from the vendored `anymal.urdf` + `anymal_hardware.toml`."""

from __future__ import annotations

from jiminy_torch.envs import assets, builders
from jiminy_torch.envs.locomotion import WalkerEnv
from jiminy_torch.gym.blocks import PDController
from jiminy_torch.gym.pipeline import ControlledEnv


class ANYmalEnv(WalkerEnv):
    def __init__(self, step_dt: float = 0.04, horizon: int = 500, flexible: bool = False,
                 std_ratio: float = 0.0, procedural: bool = False, **kw):
        if procedural or flexible:
            raise NotImplementedError(
                "the procedural and flexible ANYmal builders are not ported yet "
                "(ROADMAP.md queue 1 items 10 and 11)"
            )
        robot = assets.load_robot("anymal")
        super().__init__(robot, builders.anymal_standing_pose(robot.model), step_dt=step_dt,
                         horizon=horizon, std_ratio=std_ratio, **kw)


def ANYmalPDControlEnv(step_dt: float = 0.04, horizon: int = 500, kp=1500.0, kd=0.01, **kw):
    """`-pid` pipeline variant: a PD controller block on motor targets with
    the reference's gains (`anymal.py:27-31`, kp=1500, kd=0.01)."""
    env = ANYmalEnv(step_dt=step_dt, horizon=horizon, **kw)
    return ControlledEnv(env, PDController(kp=kp, kd=kd).setup(env))
