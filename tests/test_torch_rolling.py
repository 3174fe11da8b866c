"""Rolling constraints (a sphere or a wheel rolling without slip) in the
port against jiminy_tpu on the CPU at float64: the ball of jiminy_tpu's
tests/test_rolling.py (a free body of radius 0.2 m, a rolling constraint on
its centre frame).

Inputs are numpy draws from a seed. The generic rows
(`compute_constraint_system`) and the component rows
(`solver.constraint_system_components`) mirror jiminy_tpu op for op and are
held within 1e-12 of their scale; the component path's 150 steps against
the port's own generic path at q 1e-9, v 1e-8 and the multipliers 1e-6, as
jiminy_tpu's test_fused_rolling_matches_generic holds its two paths; the
physics as jiminy_tpu's test_sphere_constraint_rolls and
test_wheel_constraint_rolls check it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_torch import convert
from jiminy_torch.engine import constraints as t_constraints
from jiminy_torch.engine import solver as t_solver
from jiminy_torch.engine.config import EngineOptions as TOptions
from jiminy_torch.engine.config import StepperOptions as TStepper
from jiminy_torch.engine.engine import Engine as TEngine
from jiminy_torch.engine.robot import Robot as TRobot
from jiminy_torch.models import build_model as t_build_model
from jiminy_torch.models.joints import JointType as TJointType
from jiminy_torch.ops import lie as t_lie
from jiminy_torch.ops.kinematics import forward_kinematics as t_fk
from jiminy_torch.ops.kinematics import joint_space_jacobian as t_jac
from jiminy_tpu.engine import Engine as JEngine
from jiminy_tpu.engine import EngineOptions as JOptions
from jiminy_tpu.engine import Robot as JRobot
from jiminy_tpu.engine import constraints as j_constraints
from jiminy_tpu.engine import solver as j_solver
from jiminy_tpu.engine.config import StepperOptions as JStepper
from jiminy_tpu.models import JointType as JJointType
from jiminy_tpu.models import build_model as j_build_model
from jiminy_tpu.ops.kinematics import forward_kinematics as j_fk
from jiminy_tpu.ops.kinematics import joint_space_jacobian as j_jac

RADIUS = 0.2
SPECS = {"sphere": {"frame_name": "center", "radius": RADIUS},
         "wheel": {"frame_name": "center", "radius": RADIUS, "axis": (0.0, 1.0, 0.0)}}
ATOL = 1e-12
B = 6


def _ball(build_model, joint_type, robot_cls, spec):
    model = build_model(
        "ball",
        [{"name": "root_joint", "type": joint_type.FREE, "parent": -1, "mass": 1.0,
          "com": np.zeros(3), "inertia": np.eye(3) * (2.0 / 5.0) * RADIUS**2}],
        [{"name": "center", "parent": 0, "placement": (np.eye(3), np.zeros(3))}],
    )
    return robot_cls.build(model, rolling_constraints=[spec])


def _engines(spec):
    t_eng = TEngine(_ball(t_build_model, TJointType, TRobot, spec),
                    TOptions(stepper=TStepper(dt_max=1e-3)), device="cpu", dtype=torch.float64)
    j_eng = JEngine(_ball(j_build_model, JJointType, JRobot, spec),
                    JOptions(use_fast_dynamics="always", stepper=JStepper(dt_max=1e-3)))
    return t_eng, j_eng


def _close(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(float(np.abs(b).max()), 1.0))


def _comps(x):
    return [x[..., i] for i in range(x.shape[-1])]


def _dense(entries, batch):
    if isinstance(entries, (list, tuple)):
        return np.stack([_dense(e, batch) for e in entries], axis=-1)
    return np.broadcast_to(np.asarray(entries, np.float64), batch)


def _states(seed):
    """Tilted, spinning balls near the ground and reference heights near r."""
    rng = np.random.default_rng(seed)
    q = np.tile([0.0, 0.0, RADIUS, 0.0, 0.0, 0.0, 1.0], (B, 1))
    q[:, :3] += rng.normal(size=(B, 3)) * 0.01
    w = rng.normal(size=(B, 3)) * 0.5
    th = np.linalg.norm(w, axis=1, keepdims=True)
    q[:, 3:7] = np.concatenate([w / th * np.sin(th / 2), np.cos(th / 2)], axis=1)
    v = rng.normal(size=(B, 6))
    ref = RADIUS + rng.normal(size=(B, 1)) * 0.005
    return q, v, ref


@pytest.mark.parametrize("kind", list(SPECS))
def test_rolling_rows_match_jax(kind):
    """The generic rows and the component rows of one rolling constraint
    against jiminy_tpu's, and against each other."""
    t_eng, j_eng = _engines(SPECS[kind])
    assert t_eng.cset.n_rolling == 1 and t_eng.cset.total_rows == 3
    assert (t_eng.cset.sphere_specs, t_eng.cset.wheel_specs) == (
        tuple(j_eng.cset.sphere_specs), tuple(tuple(w) for w in j_eng.cset.wheel_specs))
    q, v, ref = _states(3)
    tm, jm = t_eng.robot.model, j_eng.robot.model
    qt, vt, rt = (torch.as_tensor(x) for x in (q, v, ref))
    kin_t = t_fk(tm, qt, vt, torch.zeros_like(vt))
    kin_j = j_fk(jm, jnp.asarray(q), jnp.asarray(v), jnp.zeros(v.shape))
    none_t = torch.zeros((B, 0), dtype=torch.bool)
    csys_t = t_constraints.compute_constraint_system(
        tm, t_eng.cset, t_eng.options.contacts, None, kin_t, t_jac(tm, kin_t), qt, vt,
        none_t, none_t, rolling_ref=rt)
    csys_j = j_constraints.compute_constraint_system(
        jm, j_eng.cset, j_eng.options.contacts, None, kin_j, j_jac(jm, kin_j), jnp.asarray(q),
        jnp.asarray(v), jnp.zeros((B, 0), bool), jnp.zeros((B, 0), bool),
        rolling_ref=jnp.asarray(ref))
    _close(csys_t.jac.numpy(), np.asarray(csys_j.jac), ATOL)
    _close(csys_t.drift.numpy(), np.asarray(csys_j.drift), ATOL)
    assert bool(csys_t.active.all())

    o = t_eng._solver_opts
    rows = []
    for cd, qc, vc, rr in ((t_eng._cdyn_cm, _comps(qt), _comps(vt), [rt[:, 0]]),
                           (j_eng._cdyn_cm, _comps(jnp.asarray(q)), _comps(jnp.asarray(v)),
                            [jnp.asarray(ref[:, 0])])):
        xs = cd._joint_x(qc)
        world = cd._world_placements(xs)
        vel, acc = cd._vel_bias_components(xs, vc)
        if cd is t_eng._cdyn_cm:
            rows.append(t_solver.constraint_system_components(
                cd, t_eng.cset, qc, vc, xs, world, vel, acc, o.kp, o.kd, o.transition_eps, [], [],
                (), rr)[:2])
        else:
            rows.append(j_solver.constraint_system_components(
                cd, j_eng.cset, qc, vc, xs, world, vel, acc, None, o.kp, o.kd, o.transition_eps,
                [], [], [], rr)[:2])
    for got, want in zip(rows[0], rows[1]):
        _close(_dense(got, (B,)), _dense(want, (B,)), ATOL)
    # component rows against the generic rows
    _close(_dense(rows[0][0], (B,)).transpose(0, 2, 1), csys_t.jac.numpy(), ATOL)
    _close(_dense(rows[0][1], (B,)), csys_t.drift.numpy(), ATOL)


@pytest.mark.parametrize("kind", list(SPECS))
def test_rolling_component_path_matches_generic_path(kind):
    """150 steps of 1 ms from a spinning ball on the component core and on
    the generic path (jiminy_tpu's test_fused_rolling_matches_generic), then
    the physics of jiminy_tpu's test_sphere_constraint_rolls over 200 steps:
    no slip, the height kept, the ball travelled."""
    spec = SPECS[kind]
    robot = _ball(t_build_model, TJointType, TRobot, spec)
    opts = TOptions(stepper=TStepper(dt_max=1e-3))
    core = TEngine(robot, opts, device="cpu", dtype=torch.float64)
    generic = TEngine(robot, opts.replace(use_fast_dynamics=False), device="cpu",
                      dtype=torch.float64)
    assert core._cdyn_cm is not None and generic._cdyn_cm is None
    q0 = torch.tensor([0.0, 0.0, RADIUS, 0.0, 0.0, 0.0, 1.0], dtype=torch.float64)
    v0 = torch.zeros(6, dtype=torch.float64)
    v0[4] = 2.0  # spin about y
    st_c, st_g = core.reset(q0, v0), generic.reset(q0, v0)
    torch.testing.assert_close(st_c.rolling_ref, torch.tensor([RADIUS], dtype=torch.float64))
    for _ in range(150):
        st_c, st_g = core.step(st_c), generic.step(st_g)
    torch.testing.assert_close(st_c.q, st_g.q, rtol=0, atol=1e-9)
    torch.testing.assert_close(st_c.v, st_g.v, rtol=0, atol=1e-8)
    torch.testing.assert_close(st_c.lam, st_g.lam, rtol=0, atol=1e-6)
    for _ in range(50):
        st_c = core.step(st_c)
    rot = t_lie.quat_to_mat(st_c.q[3:7])
    v_world = t_lie.mv(rot, st_c.v[0:3])
    w_world = t_lie.mv(rot, st_c.v[3:6])
    assert abs(float(v_world[0] - w_world[1] * RADIUS)) < 1e-4  # no slip
    v_expected = 0.4 / 1.4 * 2.0 * RADIUS  # I / (I + m r^2) w0 r
    assert abs(float(v_world[0]) - v_expected) < 0.25 * v_expected + 1e-3
    assert abs(float(st_c.q[2]) - RADIUS) < 1e-3
    assert float(st_c.q[0]) > 0.015


def test_rolling_state_carries_across():
    """jiminy_tpu's reset state of the ball, its rolling height included,
    converted: the port's own reset state, and the same next step."""
    t_eng, j_eng = _engines(SPECS["wheel"])
    q0 = np.array([0.01, -0.02, RADIUS + 0.003, 0.0, 0.0, 0.0, 1.0])
    v0 = np.array([0.1, 0.0, 0.0, 0.3, 2.0, -0.1])
    st_j = j_eng.reset(jnp.asarray(q0), jnp.asarray(v0))
    arrays = {f: np.asarray(getattr(st_j, f)) for f in convert.SIM_FIELDS + convert.SOLVER_FIELDS}
    arrays["stepper"] = {f: np.asarray(getattr(st_j.stepper, f)) for f in convert.STEPPER_FIELDS}
    st_c = convert.sim_state_from_arrays(arrays)
    st_t = t_eng.reset(torch.as_tensor(q0), torch.as_tensor(v0))
    for f in ("q", "v", "a", "lam", "rolling_ref", "distance_ref"):
        torch.testing.assert_close(getattr(st_c, f), getattr(st_t, f), rtol=0, atol=1e-12)
    assert float(st_c.rolling_ref[0]) == RADIUS + 0.003
    s1, s2 = t_eng.step(st_c), t_eng.step(st_t)
    torch.testing.assert_close(s1.q, s2.q, rtol=0, atol=1e-12)
    torch.testing.assert_close(s1.lam, s2.lam, rtol=0, atol=1e-9)
