"""Adaptive DOPRI 5(4) in the port (`jiminy_torch.engine.steppers`, the
engine's masked lock-step loop and the log maps it measures errors with)
against jiminy_tpu on the CPU at float64, and against scipy's dopri5.

Inputs are made with numpy from a seed and handed to both packages. The log
maps and the stepper pieces mirror jiminy_tpu op for op: 1e-12. The engine
runs its component core (`_accel_core`) where jiminy_tpu on the CPU runs its
generic ABA: the same math reassociated, so q, v, a and the adaptive step
agree within 1e-9 (absolute and relative) and the accepted and rejected
trial counts exactly. The
scipy ports keep jiminy_tpu's own tolerances (tests/test_engine.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import ode

from jiminy_torch.engine import config as t_config
from jiminy_torch.engine import steppers as t_steppers
from jiminy_torch.engine.engine import Engine as TEngine
from jiminy_torch.engine.robot import Robot as TRobot
from jiminy_torch.envs import make as t_make
from jiminy_torch.models import joints as t_joints
from jiminy_torch.models.model import build_model as t_build_model
from jiminy_torch.ops import integrate as t_integ
from jiminy_torch.testing import constraint_mode_options, dopri_options
from jiminy_tpu.engine import config as j_config
from jiminy_tpu.engine import steppers as j_steppers
from jiminy_tpu.envs import make as j_make
from jiminy_tpu.models import joints as j_joints
from jiminy_tpu.ops import integrate as j_integ

GRAV = 9.81


@pytest.fixture(scope="module")
def anymal():
    """The ANYmal of both packages under DOPRI (the port on the CPU, float64)."""
    t_env = t_make("anymal-pid", device="cpu", dtype=torch.float64,
                   options=dopri_options(t_make("anymal-pid", device="cpu").engine.options))
    j_opts = j_make("anymal-pid").env.engine.options
    j_opts = j_opts.replace(stepper=dataclasses.replace(
        j_opts.stepper, integrator=j_config.IntegratorType.RUNGE_KUTTA_DOPRI))
    return t_env, j_make("anymal-pid", options=j_opts)


def _quat(axis_angle):
    th = np.linalg.norm(axis_angle, axis=-1, keepdims=True)
    s = np.sin(th / 2) / np.where(th > 0, th, 1.0)
    return np.concatenate([axis_angle * np.where(th > 0, s, 0.5), np.cos(th / 2)], axis=-1)


def _configs(rng, t_env, batch):
    q = np.tile(np.asarray(t_env.nominal_q, np.float64), (batch, 1))
    q[:, :3] += rng.normal(size=(batch, 3)) * 0.3
    q[:, 3:7] = _quat(rng.normal(size=(batch, 3)))
    q[:, 7:] += rng.normal(size=(batch, 12)) * 0.5
    return q


def _rotated(rng, q0, angles):
    """q0 with its base turned by the given angles about random axes."""
    axes = rng.normal(size=(len(angles), 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    dq = _quat(axes * np.asarray(angles)[:, None])
    x1, y1, z1, w1 = np.moveaxis(q0[:, 3:7], -1, 0)
    x2, y2, z2, w2 = np.moveaxis(dq, -1, 0)
    q1 = q0.copy()
    q1[:, :3] += rng.normal(size=(len(angles), 3))
    q1[:, 3:7] = np.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                           w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                           w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                           w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], axis=-1)
    q1[:, 7:] += rng.normal(size=(len(angles), q0.shape[1] - 7))
    return q1


@pytest.mark.parametrize("case", ["random", "near_identity", "near_pi"])
def test_difference_matches_jax(anymal, case):
    t_env, _ = anymal
    model = t_env.robot.model
    rng = np.random.default_rng(0)
    q0 = _configs(rng, t_env, 8)
    if case == "random":
        q1 = _configs(rng, t_env, 8)
    elif case == "near_identity":
        q1 = _rotated(rng, q0, [0.0, 1e-12, 1e-9, 1e-7, 1e-5, 1e-4, 9e-4, 2e-3])
    else:
        q1 = _rotated(rng, q0, np.pi - np.array([0.0, 1e-12, 1e-9, 1e-7, 1e-5, 1e-3, 1e-2, 0.1]))
    got = t_integ.difference(model, torch.as_tensor(q0), torch.as_tensor(q1)).numpy()
    ref = np.asarray(j_integ.difference(anymal[1].robot.model, jnp.asarray(q0), jnp.asarray(q1)))
    assert got.shape == (8, model.nv) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-12, rtol=1e-12)


def test_log6_matches_jax():
    rng = np.random.default_rng(1)
    angles = np.concatenate([[0.0, 1e-10, 1e-7, 1e-4, 1e-3], rng.uniform(0, np.pi, 6),
                             np.pi - np.array([1e-3, 1e-6, 1e-9, 0.0])])
    axes = rng.normal(size=(len(angles), 3))
    quat = _quat(axes / np.linalg.norm(axes, axis=1, keepdims=True) * angles[:, None])
    p = rng.normal(size=(len(angles), 3))
    from jiminy_torch.ops import lie as t_lie
    from jiminy_tpu.ops import lie as j_lie

    rot_t = t_lie.quat_to_mat(torch.as_tensor(quat))
    rot_j = j_lie.quat_to_mat(jnp.asarray(quat))
    for got, ref in zip(t_joints._log6(rot_t, torch.as_tensor(p)),
                        j_joints._log6(rot_j, jnp.asarray(p))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("kind", ["revolute", "prismatic"])
def test_difference_fixed_base(kind):
    """A fixed-base chain (no free-flyer): plain differences; an empty model
    gives a zero-width tangent vector."""
    jtype = t_joints.JointType.REVOLUTE if kind == "revolute" else t_joints.JointType.PRISMATIC
    joints = [{"name": f"j{i}", "type": jtype, "parent": i - 1, "axis": np.array([0.0, 1.0, 0.0]),
               "mass": 1.0, "com": np.zeros(3), "inertia": np.eye(3) * 0.01} for i in range(3)]
    model = t_build_model("chain", joints, [])
    rng = np.random.default_rng(2)
    q0, q1 = rng.normal(size=(4, 3)), rng.normal(size=(4, 3))
    got = t_integ.difference(model, torch.as_tensor(q0), torch.as_tensor(q1)).numpy()
    np.testing.assert_array_equal(got, q1 - q0)
    empty = t_build_model("empty", [], [])
    assert t_integ.difference(empty, torch.zeros(4, 0), torch.zeros(4, 0)).shape == (4, 0)


def _dyn_t(q, v):
    return -2.0 * v + 0.3 * torch.sin(q[..., 1:])


def _dyn_j(q, v):
    return -2.0 * v + 0.3 * jnp.sin(q[..., 1:])


def test_dopri_trial_matches_jax(anymal):
    t_env, j_env = anymal
    rng = np.random.default_rng(3)
    q = _configs(rng, t_env, 6)
    v = rng.normal(size=(6, 18))
    a0 = rng.normal(size=(6, 18))
    dt = np.array([1e-3, 5e-4, 2e-2, 1e-6, 0.0, 3e-3])
    got = t_steppers.dopri_trial(t_env.robot.model, lambda t, q_, v_: _dyn_t(q_, v_), 0.0,
                                 *map(torch.as_tensor, (q, v, a0, dt)))
    ref = j_steppers.dopri_trial(j_env.robot.model, lambda t, q_, v_: _dyn_j(q_, v_), 0.0,
                                 *map(jnp.asarray, (q, v, a0, dt)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-12, rtol=1e-12)


def test_dopri_error_norm_and_adjust_match_jax():
    rng = np.random.default_rng(4)
    err_vec = rng.normal(size=(64, 36)) * 10.0 ** rng.uniform(-9, -3, size=(64, 1))
    mag = np.abs(rng.normal(size=(64, 36)))
    got = t_steppers.dopri_error_norm(torch.as_tensor(err_vec), torch.as_tensor(mag), 1e-5, 1e-4)
    ref = j_steppers.dopri_error_norm(jnp.asarray(err_vec), jnp.asarray(mag), 1e-5, 1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=0, rtol=1e-12)
    error = np.concatenate([np.asarray(ref), [0.0, 1e-12, 0.3, 0.5, 0.99, 1.0, 7.0, np.inf]])
    dt = rng.uniform(1e-5, 2e-3, size=error.shape)
    ok_t, dt_t = t_steppers.dopri_adjust(torch.as_tensor(dt), torch.as_tensor(error), 1e-10, 1e-3)
    ok_j, dt_j = j_steppers.dopri_adjust(jnp.asarray(dt), jnp.asarray(error), 1e-10, 1e-3)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(dt_t.numpy(), np.asarray(dt_j), atol=0, rtol=1e-12)


def test_engine_dopri_periods_match_jax(anymal):
    """Two controller periods of the ANYmal, one env standing and one
    perturbed (more trials, some rejected): the port's masked lock-step
    against `jax.jit(jax.vmap(Engine.step))`."""
    t_env, j_env = anymal
    t_eng, j_eng = t_env.engine, j_env.env.engine
    rng = np.random.default_rng(5)
    q0 = np.asarray(t_env.nominal_q, np.float64)
    q = np.stack([q0, q0])
    q[1, 7:] += rng.normal(size=12) * 0.05
    v = np.zeros((2, 18))
    v[1] = rng.normal(size=18) * 0.2
    cmd = np.zeros((2, 12))
    cmd[1] = rng.normal(size=12) * 5.0
    st_t = t_eng.reset(torch.as_tensor(q), torch.as_tensor(v))
    st_j = jax.vmap(lambda a, b: j_eng.reset(a, b))(jnp.asarray(q), jnp.asarray(v))
    step_j = jax.jit(jax.vmap(j_eng.step))
    for _ in range(2):
        st_t = t_eng.step(st_t, torch.as_tensor(cmd))
        st_j = step_j(st_j, jnp.asarray(cmd))
    for name in ("q", "v", "a", "t"):  # the accelerations run to some 1e2
        np.testing.assert_allclose(getattr(st_t, name).numpy(), np.asarray(getattr(st_j, name)),
                                   atol=1e-9, rtol=1e-9, err_msg=name)
    s_t, s_j = st_t.stepper, st_j.stepper
    np.testing.assert_allclose(s_t.dt.numpy(), np.asarray(s_j.dt), atol=1e-9, rtol=0)
    for name in ("iterations", "iter_failed", "successive_iter_failed", "diverged"):
        np.testing.assert_array_equal(getattr(s_t, name).numpy(), np.asarray(getattr(s_j, name)))
    trials = (s_t.iterations + s_t.iter_failed).numpy()
    assert trials[1] > trials[0] and s_t.iter_failed[1] > 0  # the envs really differ


def _scipy_traj(f, y0, ts):
    r = ode(f).set_integrator("dopri5", rtol=1e-12, atol=1e-12, nsteps=100000)
    r.set_initial_value(list(y0), 0.0)
    out = []
    for t in ts:
        r.integrate(t)
        out.append(np.array(r.y))
    return np.array(out)


def _simulate(eng, st, n):
    ts, qs = [], []
    for _ in range(n):
        st = eng.step(st)
        ts.append(float(st.t))
        qs.append(float(st.q[0]))
    return np.array(ts), np.array(qs)


def test_pendulum_dopri_vs_scipy():
    """tests/test_engine.py's pendulum under DOPRI, at its tolerance 1e-7."""
    length = 0.8
    model = t_build_model(
        "pendulum",
        [{"name": "pivot", "type": t_joints.JointType.REVOLUTE, "parent": -1,
          "axis": np.array([0.0, 1.0, 0.0]), "mass": 1.5, "com": np.array([0.0, 0.0, -length]),
          "inertia": np.zeros((3, 3))}],
        [{"name": "tip", "parent": 0, "placement": (np.eye(3), np.array([0.0, 0.0, -length]))}],
    )
    robot = TRobot.build(model, motors=[{"joint_name": "pivot", "armature": 0.0}])
    opts = t_config.EngineOptions(stepper=t_config.StepperOptions(
        integrator=t_config.IntegratorType.RUNGE_KUTTA_DOPRI, dt_max=1e-3, tol_abs=1e-10,
        tol_rel=1e-10))
    eng = TEngine(robot, opts, device="cpu", dtype=torch.float64)
    ts, qs = _simulate(eng, eng.reset(torch.tensor([0.3], dtype=torch.float64)), 500)
    ref = _scipy_traj(lambda t, y: [y[1], -GRAV / length * np.sin(y[0])], [0.3, 0.0], ts)
    assert np.max(np.abs(qs - ref[:, 0])) < 1e-7


def test_bouncing_mass_dopri_vs_scipy():
    """tests/test_engine.py's spring-damper point mass under DOPRI, at its
    tolerance 1e-6: contact, rejected trials and all."""
    k, nu, m = 1.0e4, 1.0e2, 1.0
    model = t_build_model(
        "mass",
        [{"name": "slider", "type": t_joints.JointType.PRISMATIC, "parent": -1,
          "axis": np.array([0.0, 0.0, 1.0]), "mass": m, "com": np.zeros(3),
          "inertia": np.zeros((3, 3))}],
        [{"name": "contact", "parent": 0, "placement": (np.eye(3), np.zeros(3))}],
    )
    robot = TRobot.build(model, contact_frames=["contact"])
    opts = t_config.EngineOptions(
        contacts=t_config.ContactOptions(stiffness=k, damping=nu, friction=0.0,
                                         transition_eps=0.0, transition_velocity=1e-2),
        stepper=t_config.StepperOptions(integrator=t_config.IntegratorType.RUNGE_KUTTA_DOPRI,
                                        tol_abs=1e-8, tol_rel=1e-8),
    )
    eng = TEngine(robot, opts, device="cpu", dtype=torch.float64)
    st = eng.reset(torch.tensor([0.1], dtype=torch.float64))
    ts, qs = _simulate(eng, st, 600)

    def f(t, y):
        z, vz = y
        fc = max(-(k * z + nu * vz), 0.0) if z < 0 else 0.0
        return [vz, fc / m - GRAV]

    ref = _scipy_traj(f, [0.1, 0.0], ts)
    assert qs.min() < 0.0  # it did hit the ground
    assert np.max(np.abs(qs - ref[:, 0])) < 1e-6


def test_dopri_routes_and_refusals(anymal):
    """DOPRI steps period by period (no fused rollout); beside PGS rows it is
    refused, naming the ROADMAP item that will port it."""
    t_env, _ = anymal
    assert not t_env.engine.supports_fused_rollout
    assert t_make("anymal-pid", device="cpu").engine.supports_fused_rollout
    st = t_env.engine.reset(t_env.nominal_q)
    assert float(st.stepper.dt) == min(t_env.engine.options.stepper.dt_init,
                                       t_env.engine.options.stepper.dt_max)
    cm = constraint_mode_options(t_env.engine.options)
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        TEngine(t_env.robot, cm, device="cpu")
