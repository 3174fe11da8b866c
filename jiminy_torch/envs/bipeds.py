"""Biped and humanoid environments (port of `jiminy_tpu.envs.bipeds`): the
reference's URDF and hardware files (`envs.assets.load_robot`). Cassie and
Digit with the passive shin joints locked and the pushrod loop closures as
distance constraints, the toe meshes' lowest box corners as contact points;
Atlas with the foot boxes' corner contact points pruned to the support hull,
and its reduced variant with every non-leg joint locked at the posed
configuration. `procedural=True` takes the parametric look-alikes
(`envs/builders_bipeds.py`) instead.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

from jiminy_torch.envs import assets
from jiminy_torch.envs import builders_bipeds as bb
from jiminy_torch.envs.locomotion import WalkerEnv
from jiminy_torch.gym.blocks import PDController
from jiminy_torch.gym.pipeline import ControlledEnv


class CassieEnv(WalkerEnv):
    """Cassie biped with the pushrod loop closures (reference
    `CassieJiminyEnv`, `cassie.py:67-140`); `procedural`: the look-alike
    of `builders_bipeds.build_cassie`."""

    def __init__(self, step_dt: float = 0.04, horizon: int = 500, procedural: bool = False,
                 **kw):
        if procedural:
            robot = bb.build_cassie()
            q0 = bb.cassie_standing_pose(robot.model)
        else:
            robot = assets.load_robot("cassie")
            q0 = assets.nominal_pose("cassie", robot.model)
        kw.setdefault("base_height_min", 0.5)
        kw.setdefault("simulation_dt", 5.0e-4)
        super().__init__(robot, q0, step_dt=step_dt, horizon=horizon, **kw)


class DigitEnv(WalkerEnv):
    """Digit biped (reference `DigitJiminyEnv`, `digit.py:85`); `procedural`:
    the look-alike of `builders_bipeds.build_digit`."""

    def __init__(self, step_dt: float = 0.04, horizon: int = 500, procedural: bool = False,
                 **kw):
        if procedural:
            robot = bb.build_digit()
            q0 = bb.cassie_standing_pose(robot.model)
            q0[2] = 1.0
        else:
            robot = assets.load_robot("digit")
            q0 = assets.nominal_pose("digit", robot.model)
        kw.setdefault("base_height_min", 0.55)
        kw.setdefault("simulation_dt", 5.0e-4)
        super().__init__(robot, q0, step_dt=step_dt, horizon=horizon, **kw)


class AtlasEnv(WalkerEnv):
    """Atlas humanoid (reference `AtlasJiminyEnv`, `atlas.py:113`);
    `procedural`: the look-alike of `builders_bipeds.build_atlas`."""

    def __init__(self, step_dt: float = 0.04, horizon: int = 500,
                 reduced: bool = False, procedural: bool = False, **kw):
        if procedural:
            robot = bb.build_atlas(reduced=reduced)
            q0 = bb.atlas_standing_pose(robot.model)
        else:
            robot = assets.load_robot("atlas",
                                      lock_joints=_atlas_lock_angles() if reduced else ())
            q0 = assets.nominal_pose("atlas", robot.model)
        kw.setdefault("base_height_min", 0.55)
        kw.setdefault("simulation_dt", 5.0e-4)
        super().__init__(robot, q0, step_dt=step_dt, horizon=horizon, **kw)


def _atlas_lock_angles() -> dict:
    """Locked-joint angles of the reduced Atlas: every non-leg movable joint
    at the posed configuration (reference `atlas.py:152-169, 200-207`)."""
    root = ET.parse(assets.urdf_path("atlas")).getroot()
    return {
        j.get("name"): assets.ATLAS_POSE.get(j.get("name"), 0.0)
        for j in root.findall("joint")
        if j.get("type") != "fixed" and "_leg_" not in j.get("name")
    }


class AtlasReducedEnv(AtlasEnv):
    """Atlas with arms, neck and back locked at the posed configuration
    (reference `AtlasReducedJiminyEnv`)."""

    def __init__(self, **kw):
        kw["reduced"] = True
        super().__init__(**kw)


def _pd_env(env, kp, kd, table, default=None):
    if kp is None or kd is None:
        kp_t, kd_t = bb.pd_gains(env.robot, table, default=default)
        kp = kp_t if kp is None else kp
        kd = kd_t if kd is None else kd
    return ControlledEnv(env, PDController(kp=kp, kd=kd).setup(env))


def AtlasPDControlEnv(step_dt: float = 0.04, horizon: int = 500, kp=None, kd=None, **kw):
    """Reference `AtlasPDControlJiminyEnv`, the robot of the reference's own
    headline benchmark; default gains from `ATLAS_PD_EFFECTIVE`."""
    return _pd_env(AtlasEnv(step_dt=step_dt, horizon=horizon, **kw), kp, kd,
                   bb.ATLAS_PD_EFFECTIVE)


def AtlasReducedPDControlEnv(step_dt: float = 0.04, horizon: int = 500, kp=None, kd=None,
                             **kw):
    """Reference `AtlasReducedPDControlJiminyEnv` (the leg gains of the same
    table)."""
    kw["reduced"] = True
    return _pd_env(AtlasEnv(step_dt=step_dt, horizon=horizon, **kw), kp, kd,
                   bb.ATLAS_PD_EFFECTIVE)


def CassiePDControlEnv(step_dt: float = 0.04, horizon: int = 500, kp=None, kd=None, **kw):
    """Reference `CassiePDControlJiminyEnv`; default gains from
    `CASSIE_PD_EFFECTIVE`."""
    return _pd_env(CassieEnv(step_dt=step_dt, horizon=horizon, **kw), kp, kd,
                   bb.CASSIE_PD_EFFECTIVE, bb.REFERENCE_DEFAULT_GAINS)


def DigitPDControlEnv(step_dt: float = 0.04, horizon: int = 500, kp=None, kd=None, **kw):
    """Reference `DigitPDControlJiminyEnv`; default gains from
    `DIGIT_PD_EFFECTIVE`, the toes' from `REFERENCE_DEFAULT_GAINS`."""
    return _pd_env(DigitEnv(step_dt=step_dt, horizon=horizon, **kw), kp, kd,
                   bb.DIGIT_PD_EFFECTIVE, bb.REFERENCE_DEFAULT_GAINS)
