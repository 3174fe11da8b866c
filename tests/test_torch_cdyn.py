"""The port's plain component core (`jiminy_torch.ops.cdyn`) against jiminy_tpu
on the CPU at float64, module by module: one dynamics evaluation, the
post-step aux outputs, and the period and rollout integrators.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are jiminy_tpu's own for the same comparisons
(tests/test_cdyn.py): 1e-10 for a free-flyer evaluation against the generic
ABA, 1e-9 with contacts, 1e-10 for the aux outputs. The port's core mirrors
jiminy_tpu's component core op for op, so against that core it is held at
1e-12, and the integrators and env steps at 1e-12 absolute plus 1e-12
relative (XLA compiles jiminy_tpu's scans and may reassociate inside its
fusions; efforts of ~1e2 N m then differ in the last bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_torch.engine import config as t_config
from jiminy_torch.engine.robot import Robot as TRobot
from jiminy_torch.envs import make as t_make
from jiminy_torch.gym.base import BaseEnv as TBaseEnv
from jiminy_torch.gym.blocks import PDController as TPD
from jiminy_torch.gym.pipeline import ControlledEnv as TControlled
from jiminy_torch.models.model import build_model as t_build_model
from jiminy_torch.ops import cdyn as t_cdyn
from jiminy_tpu.engine import config as j_config
from jiminy_tpu.engine.contact import compute_contact_forces
from jiminy_tpu.engine.internal import penalty_bounds_torque
from jiminy_tpu.engine.robot import Robot as JRobot
from jiminy_tpu.envs import make as j_make
from jiminy_tpu.gym.base import BaseEnv as JBaseEnv
from jiminy_tpu.gym.blocks import PDController as JPD
from jiminy_tpu.gym.pipeline import ControlledEnv as JControlled
from jiminy_tpu.models import build_model as j_build_model
from jiminy_tpu.ops import cdyn as j_cdyn
from jiminy_tpu.ops import dynamics as j_dyn
from jiminy_tpu.ops.kinematics import forward_kinematics

RNG = np.random.default_rng(0)
GRAV = (0.0, 0.0, -9.81)


@pytest.fixture(scope="module")
def anymal():
    """The anymal-pid env of both packages (port on the CPU at float64)."""
    return t_make("anymal-pid", device="cpu", dtype=torch.float64), j_make("anymal-pid")


def _states(env, batch):
    q0 = np.asarray(env.nominal_q, np.float64)
    q = np.tile(q0, (batch, 1))
    q[:, 2] += RNG.uniform(-0.03, 0.01, size=batch)
    q[:, 7:] += RNG.normal(size=(batch, q.shape[1] - 7)) * 0.3
    w = RNG.normal(size=(batch, 3)) * 0.2
    th = np.linalg.norm(w, axis=1, keepdims=True)
    q[:, 3:7] = np.concatenate([w / th * np.sin(th / 2), np.cos(th / 2)], axis=1)
    nv = env.robot.nv
    return q, RNG.normal(size=(batch, nv)) * 0.5, RNG.normal(size=(batch, nv)) * 5.0


def test_penalty_bound_gains_match_jax(anymal):
    t_env, j_env = anymal
    tg = t_env.engine._bound_gains
    jg = j_env.engine._bound_gains
    assert set(tg) == set(jg)
    for k in tg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-13, atol=0)


def test_accel_matches_jax_freeflyer_without_contacts(anymal):
    t_env, j_env = anymal
    t_model, j_model = t_env.robot.model, j_env.robot.model
    q, v, tau = _states(t_env, 5)
    out = t_cdyn.ComponentDynamics(t_model, GRAV).accel(*map(torch.as_tensor, (q, v, tau)))
    ref = j_dyn.aba(j_model, jnp.asarray(GRAV), jnp.asarray(q), jnp.asarray(v), jnp.asarray(tau))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-10, rtol=0)
    ref_cd = j_cdyn.ComponentDynamics(j_model, GRAV).accel(*map(jnp.asarray, (q, v, tau)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_cd), atol=1e-12, rtol=0)


def test_accel_matches_jax_with_contacts_and_bounds(anymal):
    """The engine's own core: spring-damper feet and penalty joint bounds,
    some feet in the ground and some joints past their bounds."""
    t_env, j_env = anymal
    robot = j_env.robot
    j_model = robot.model
    q, v, tau = _states(t_env, 6)
    q[:3, 8] = 1.0  # past LF_HFE's upper bound
    q[3:, 7] = -1.0  # past LF_HAA's lower bound
    out = t_env.engine._cdyn.accel(*map(torch.as_tensor, (q, v, tau)))

    opts = j_env.engine.options.contacts
    gains = j_env.engine._bound_gains
    cd = j_cdyn.ComponentDynamics(
        j_model, GRAV, contact_opts=opts, contact_frames=robot.contact_frame_indices,
        contact_radii=robot.contact_radii, bound_gains=gains,
    )
    ref_cd = cd.accel(*map(jnp.asarray, (q, v, tau)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_cd), atol=1e-12, rtol=0)

    qj, vj, tj = map(jnp.asarray, (q, v, tau))
    kin = forward_kinematics(j_model, qj, vj)
    fext, _, _, _ = compute_contact_forces(
        j_model, opts, None, kin, robot.contact_frame_indices, robot.contact_radii
    )
    u = tj + penalty_bounds_torque(gains, j_model.nv, qj, vj)
    ref = j_dyn.aba(j_model, jnp.asarray(GRAV), qj, vj, u, fext)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-9, rtol=0)


def test_aux_outputs_match_jax(anymal):
    t_env, j_env = anymal
    robot = j_env.robot
    q, v, a = _states(t_env, 4)
    imu = tuple(dict(robot.sensors.groups())["imu"].frame_indices)
    aux_t = t_env.engine._cdyn.aux_outputs(*map(torch.as_tensor, (q, v, a)), imu_frames=imu)
    cd = j_cdyn.ComponentDynamics(
        robot.model, GRAV, contact_opts=j_env.engine.options.contacts,
        contact_frames=robot.contact_frame_indices, contact_radii=robot.contact_radii,
    )
    aux_j = cd.aux_outputs(*map(jnp.asarray, (q, v, a)), imu_frames=imu)
    for key in ("contact_f_world", "contact_w_local", "contact_depth", "imu_raw"):
        np.testing.assert_allclose(aux_t[key].numpy(), np.asarray(aux_j[key]), atol=1e-10,
                                   rtol=0, err_msg=key)

    # ...and the generic pipeline (contact pass + FK + the IMU group's read-out)
    qj, vj, aj = map(jnp.asarray, (q, v, a))
    kin = forward_kinematics(robot.model, qj, vj, aj)
    _, f_world, w_local, depth = compute_contact_forces(
        robot.model, j_env.engine.options.contacts, None, kin, robot.contact_frame_indices,
        robot.contact_radii,
    )
    contact_f = {"gravity": jnp.asarray(GRAV), "contact_forces_local": w_local[..., 3:6],
                 "contact_wrench_local": w_local,
                 "contact_frame_indices": robot.contact_frame_indices}
    groups = dict(robot.sensors.groups())
    imu_generic = groups["imu"].compute_raw(robot.model, kin, qj, vj, aj, None, contact_f)
    for got, ref in ((aux_t["contact_f_world"], f_world), (aux_t["contact_w_local"], w_local),
                     (aux_t["contact_depth"], depth), (aux_t["imu_raw"], imu_generic)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-10, rtol=0)
    # The port's own generic IMU and force read-outs agree with jiminy_tpu's
    from jiminy_torch.ops.kinematics import forward_kinematics as t_fk

    t_robot = t_env.robot
    kin_t = t_fk(t_robot.model, *map(torch.as_tensor, (q, v, a)))
    t_groups = dict(t_robot.sensors.groups())
    contact_t = {"gravity": torch.tensor(GRAV, dtype=torch.float64),
                 "contact_wrench_local": aux_t["contact_w_local"],
                 "contact_frame_indices": t_robot.contact_frame_indices}
    args_t = (t_robot.model, kin_t, None, None, None, None, contact_t)
    args_j = (robot.model, kin, None, None, None, None, contact_f)
    for name in ("imu", "force"):
        np.testing.assert_allclose(t_groups[name].compute_raw(*args_t).numpy(),
                                   np.asarray(groups[name].compute_raw(*args_j)),
                                   atol=1e-10, rtol=0, err_msg=name)


# --------------------------------------------------------------------------- #
# Integrators on the fixed-base arm of tests/test_fused_rollout.py
# --------------------------------------------------------------------------- #

_ARM_JOINTS = [
    {
        "name": "shoulder", "type": 1, "parent": -1, "axis": np.array([0.0, 1.0, 0.0]),
        "mass": 1.0, "com": np.array([0.0, 0.0, -0.2]), "inertia": np.eye(3) * 2e-2,
        "position_limit": (np.array([-2.0]), np.array([2.0])),
        "velocity_limit": 20.0, "effort_limit": 60.0,
    },
    {
        "name": "elbow", "type": 1, "parent": 0, "axis": np.array([0.0, 1.0, 0.0]),
        "placement": (np.eye(3), np.array([0.0, 0.0, -0.4])),
        "mass": 0.6, "com": np.array([0.0, 0.0, -0.15]), "inertia": np.eye(3) * 1e-2,
        "position_limit": (np.array([-2.5]), np.array([2.5])),
        "velocity_limit": 25.0, "effort_limit": 40.0,
    },
]
_ARM_HW = dict(
    motors=[{"joint_name": "shoulder"}, {"joint_name": "elbow"}],
    sensors={
        "encoder": [{"joint_name": "shoulder"}, {"joint_name": "elbow"}],
        "effort": [{"motor_name": "shoulder"}, {"motor_name": "elbow"}],
    },
)
_PD = dict(kp=np.array([40.0, 25.0]), kd=np.array([0.2, 0.15]), target_acceleration_limit=200.0)


def _arm_options(cfg):
    return cfg.EngineOptions(
        stepper=cfg.StepperOptions(integrator=cfg.IntegratorType.RUNGE_KUTTA_4, dt_max=2e-3),
        controller_update_period=0.01,
        sensor_update_period=0.01,
        joint_bounds_mode="penalty",
    )


def _arm_envs(fused: bool):
    j_opts = _arm_options(j_config).replace(use_fast_dynamics="always")
    j_base = JBaseEnv(JRobot.build(j_build_model("arm2", _ARM_JOINTS, []), **_ARM_HW), j_opts,
                      step_dt=0.04, horizon=100)
    t_base = TBaseEnv(TRobot.build(t_build_model("arm2", _ARM_JOINTS, []), **_ARM_HW),
                      _arm_options(t_config), step_dt=0.04, horizon=100, device="cpu",
                      dtype=torch.float64)
    q0 = np.array([0.3, -0.5])
    j_base._sample_state = lambda key: (jnp.asarray(q0), jnp.zeros(2))
    t_base._sample_state = lambda batch: (
        torch.as_tensor(q0).expand(batch + (2,)), torch.zeros(batch + (2,), dtype=torch.float64)
    )
    return (
        TControlled(t_base, TPD(**_PD).setup(t_base), use_fused_rollout=fused),
        JControlled(j_base, JPD(**_PD).setup(j_base), use_fused_rollout=fused),
    )


def _arm_inputs(batch, nq=2, nm=2):
    q = RNG.uniform(-2.4, 2.4, size=(batch, nq))
    v = RNG.normal(size=(batch, nq)) * 2.0
    return q, v, RNG.normal(size=(batch, nm)) * 30.0


def test_period_integrator_matches_jax():
    t_env, j_env = _arm_envs(True)
    t_eng, j_eng = t_env.env.engine, j_env.env.engine
    q, v, cmd = _arm_inputs(5)
    out = t_eng._get_period_run("rk4")(*map(torch.as_tensor, (q, v, cmd)))
    j_run = j_eng._cdyn.make_period_integrator(
        j_eng._build_tau_c(), j_eng.tick_period / j_eng.n_substeps, j_eng.n_substeps,
        integrator="rk4", imu_frames=(),
    )
    ref = j_run(*map(jnp.asarray, (q, v, cmd)))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("controller", ["pd", "zoh"])
def test_rollout_integrator_matches_jax(controller):
    t_env, j_env = _arm_envs(True)
    t_eng, j_eng = t_env.env.engine, j_env.env.engine
    q, v, action = _arm_inputs(5)
    if controller == "pd":
        t_ctrl = t_env.block.component_controller(t_env.env)
        j_fn, n_carry = j_env.block.component_controller(j_env.env)
        carry = np.concatenate([q, RNG.normal(size=(5, 4))], axis=1)
    else:
        t_ctrl = t_cdyn.ZOHPassThrough(2)
        j_fn, n_carry = (lambda qc, vc, bc, ac: (list(ac[:2]), list(bc))), 0
        carry = np.zeros((5, 0))
    out = t_eng._get_rollout_run(controller, t_ctrl, 4)(*map(torch.as_tensor, (q, v, action, carry)))
    j_run = j_eng._cdyn.make_rollout_integrator(
        j_eng._build_tau_c(), j_eng.tick_period / j_eng.n_substeps, j_eng.n_substeps, 4,
        j_fn, n_carry, 2, 2, integrator="rk4", imu_frames=(),
    )
    ref = j_run(*map(jnp.asarray, (q, v, action, carry)))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("fused", [True, False])
def test_arm_pd_env_matches_jax(fused):
    """PD in the loop, the whole env: fused rollout and per-period paths."""
    import jax

    t_env, j_env = _arm_envs(fused)
    st_t, _ = t_env.reset()
    st_j, _ = j_env.reset(jax.random.PRNGKey(3))
    action = np.array([0.5, -0.8])
    for _ in range(3):
        st_t, _, rew_t, *_ = t_env.step(st_t, torch.as_tensor(action))
        st_j, _, rew_j, *_ = j_env.step(st_j, jnp.asarray(action))
    for a, b in (
        (st_t.sim.q, st_j.sim.q),
        (st_t.sim.v, st_j.sim.v),
        (st_t.sim.command, st_j.sim.command),
        (st_t.blocks["pd_controller"], st_j.blocks["pd_controller"]),
        (st_t.sim.measurements["encoder"], st_j.sim.measurements["encoder"]),
        (st_t.sim.measurements["effort"], st_j.sim.measurements["effort"]),
        (st_t.sim.t, st_j.sim.t),
    ):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12, rtol=1e-12)
