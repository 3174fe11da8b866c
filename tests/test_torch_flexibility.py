"""Flexibility joints in the port against jiminy_tpu on the CPU at float64.

- The extended-model surgery (a spherical joint inserted before each named
  joint) and the four theoretical/extended state maps on jiminy_tpu's own
  fixtures (the flexible pendulum of its tests/test_cdyn.py, the flexible
  arm with backlash of its tests/test_state_mapping.py) and on
  `build_anymal(flexible=True)`: model arrays within 1e-12, maps exactly;
  jiminy_tpu's robots carried across through `convert.robot_from_arrays`.
- `lie.jlog3` and `internal.flexibility_torque` on random, near-identity
  and near-pi quaternions, within 1e-12 of their scale.
- The plain component core with SPHERICAL joints (`_accel_core`, the plain
  version of `cdyn_accel`'s SPHERICAL instance) against jiminy_tpu's
  `ComponentDynamics.accel` (the ANYmal, with its contact outputs) and
  `dynamics.aba` (the pendulum), within 1e-12 of their scale; the contact
  sensors' raws.
- One RK4 substep of the flexible ANYmal's per-stage path, live against
  jiminy_tpu's component core (run eagerly), within 1e-10.
- Against jiminy_tpu's numbers in tests/goldens_torch/flexible_anymal.json
  (`python tests/goldens_torch/generate.py flexible`): with
  `testing.resolving_options` one controller period through `Engine.step`
  in both contact modes within 1e-10 (constraint contact mode takes the
  generic path, as jiminy_tpu's XLA path); as configured (RK4 at 1 ms)
  jiminy_tpu's first env step is non-finite in every entry, and the state
  after two controller periods in both programs: the flexibility's damped
  mode lies outside RK4's stability interval.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_torch.engine import internal as t_internal
from jiminy_torch.engine import steppers as t_steppers
from jiminy_torch.engine.robot import Robot as TRobot
from jiminy_torch.envs import builders as t_builders
from jiminy_torch.envs import make as t_make
from jiminy_torch.models.model import ARRAY_FIELDS, META_FIELDS
from jiminy_torch.models.model import build_model as t_build_model
from jiminy_torch.ops import cdyn as t_cdyn
from jiminy_torch.ops import lie as t_lie
from jiminy_torch.testing import constraint_mode_options, flexible_states, resolving_options
from jiminy_tpu.engine import internal as j_internal
from jiminy_tpu.engine import steppers as j_steppers
from jiminy_tpu.engine.robot import Robot as JRobot
from jiminy_tpu.envs import builders as j_builders
from jiminy_tpu.envs import make as j_make
from jiminy_tpu.models import build_model as j_build_model
from jiminy_tpu.ops import cdyn as j_cdyn
from jiminy_tpu.ops import dynamics as j_dyn
from jiminy_tpu.ops import lie as j_lie

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens_torch", "flexible_anymal.json")
GRAV = (0.0, 0.0, -9.81)


def _close(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1.0) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale)


def _pendulum_specs():
    """jiminy_tpu's tests/test_cdyn.py flexible pendulum (before the surgery)."""
    return [
        {"name": "pivot", "type": 1, "parent": -1, "axis": np.array([0.0, 1.0, 0.0]),
         "mass": 1.0, "com": np.array([0.0, 0.0, -0.4]), "inertia": np.eye(3) * 1e-2},
        {"name": "elbow", "type": 1, "parent": 0, "axis": np.array([0.0, 1.0, 0.0]),
         "placement": (np.eye(3), np.array([0.0, 0.0, -0.8])), "mass": 0.7,
         "com": np.array([0.0, 0.0, -0.3]), "inertia": np.eye(3) * 5e-3},
    ]


def _arm_specs():
    """jiminy_tpu's tests/test_state_mapping.py arm."""
    return [
        {"name": "shoulder", "type": 1, "parent": -1, "axis": np.array([0.0, 1.0, 0.0]),
         "mass": 1.0, "com": np.array([0.0, 0.0, -0.5]), "inertia": np.eye(3) * 0.05},
        {"name": "elbow", "type": 1, "parent": 0, "axis": np.array([0.0, 1.0, 0.0]),
         "placement": (np.eye(3), np.array([0.0, 0.0, -1.0])), "mass": 0.5,
         "com": np.array([0.0, 0.0, -0.25]), "inertia": np.eye(3) * 0.02},
    ]


def _robots(name):
    """(port robot, jiminy_tpu robot) of a fixture."""
    if name == "anymal":
        return t_builders.build_anymal(True), j_builders.build_anymal(True)
    if name == "pendulum":
        specs, frames = _pendulum_specs(), []
        kw = dict(motors=[{"joint_name": "pivot"}],
                  flexibility=[{"joint_name": "elbow", "stiffness": (50.0, 60.0, 70.0),
                                "damping": (0.5, 0.4, 0.3), "inertia": (1e-3, 1e-3, 1e-3)}])
    else:
        specs = _arm_specs()
        frames = [{"name": "tip", "parent": 1, "placement": (np.eye(3), np.array([0.0, 0.0, -0.5]))}]
        kw = dict(motors=[{"joint_name": "elbow", "backlash": 0.02}],
                  flexibility=[{"joint_name": "elbow", "stiffness": [50.0] * 3,
                                "damping": [1.0] * 3, "inertia": [1e-3] * 3}])
    return (TRobot.build(t_build_model(name, specs, frames), **kw),
            JRobot.build(j_build_model(name, specs, frames), **kw))


def _models_match(tm, jm):
    for f in META_FIELDS:
        a, b = getattr(tm, f), getattr(jm, f)
        assert (tuple(a) if isinstance(a, (tuple, list)) else a) == (
            tuple(b) if isinstance(b, (tuple, list)) else b), f
    for f in ARRAY_FIELDS:
        a, b = getattr(tm, f), np.asarray(getattr(jm, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=f)


@pytest.mark.parametrize("name", ["pendulum", "arm", "anymal"])
def test_flexibility_surgery_matches_jax(name):
    tr, jr = _robots(name)
    _models_match(tr.model, jr.model)
    _models_match(tr.theoretical_model, jr.theoretical_model)
    assert tr.flexibility.joint_indices == tuple(jr.flexibility.joint_indices)
    for f in ("stiffness", "damping", "inertia"):
        np.testing.assert_allclose(getattr(tr.flexibility, f),
                                   np.asarray(getattr(jr.flexibility, f)), rtol=0, atol=1e-12)
    assert tr.backlash_joint_indices == tuple(jr.backlash_joint_indices)
    assert tr.motors.joint_indices == tuple(jr.motors.joint_indices)
    assert tr.motors.v_indices == tuple(jr.motors.v_indices)
    assert tr.motors.q_indices == tuple(jr.motors.q_indices)
    assert t_cdyn.supports_model(tr.model)
    if name == "anymal":  # nq 35, nv 30, 17 joints (4 SPHERICAL), 12 motors, 4 feet
        m = tr.model
        assert (m.nq, m.nv, m.njoints, tr.nmotors) == (35, 30, 17, 12)
        assert sum(t == 4 for t in m.joint_types) == 4 and len(tr.contact_frame_indices) == 4
        assert [g for g, _ in tr.sensors.groups()] == ["encoder", "effort", "imu", "contact",
                                                      "force"]
        assert tr.sensors.contact.contact_slots == tuple(jr.sensors.contact.contact_slots)


@pytest.mark.parametrize("name", ["arm", "anymal"])
def test_extended_robot_carries_across_from_arrays(name):
    """jiminy_tpu's extended robot through `convert.robot_from_arrays` (its
    model's, motors', flexibility and theoretical model's numbers, backlash
    indices): the flexibility torques and state maps of the port's own."""
    from jiminy_torch import convert
    from jiminy_torch.engine.hardware import MOTOR_ARRAY_FIELDS

    tr, jr = _robots(name)

    def arrays(model):
        out = {f: getattr(model, f) for f in META_FIELDS}
        out.update({f: np.asarray(getattr(model, f)) for f in ARRAY_FIELDS})
        return out

    motors = {f: getattr(jr.motors, f) for f in convert.MOTOR_META_FIELDS}
    motors.update({f: np.asarray(getattr(jr.motors, f)) for f in MOTOR_ARRAY_FIELDS})
    flex = {f: np.asarray(getattr(jr.flexibility, f)) for f in ("stiffness", "damping", "inertia")}
    robot = convert.robot_from_arrays(
        arrays(jr.model), motors, contact_frames=jr.contact_frame_indices,
        flexibility={"joint_indices": jr.flexibility.joint_indices, **flex},
        backlash_joint_indices=jr.backlash_joint_indices,
        theoretical_arrays=arrays(jr.theoretical_model))
    assert robot.backlash_joint_indices == tr.backlash_joint_indices
    m = tr.model
    rng = np.random.default_rng(4)
    q = np.tile(m.neutral(), (6, 1))
    for j in tr.flexibility.joint_indices:
        q[:, m.q_slice(j)] = _quaternions(rng, 2)[:6]
    q, v = torch.as_tensor(q), torch.as_tensor(rng.normal(size=(6, m.nv)))
    np.testing.assert_array_equal(t_internal.flexibility_torque(robot, q, v).numpy(),
                                  t_internal.flexibility_torque(tr, q, v).numpy())
    np.testing.assert_array_equal(robot.theoretical_position_from_extended(q).numpy(),
                                  tr.theoretical_position_from_extended(q).numpy())


@pytest.mark.parametrize("name", ["arm", "anymal"])
def test_state_maps_match_jax(name):
    tr, jr = _robots(name)
    rng = np.random.default_rng(0)
    th, ext = tr.theoretical_model, tr.model
    for fn, n in (("extended_position_from_theoretical", th.nq),
                  ("extended_velocity_from_theoretical", th.nv),
                  ("theoretical_position_from_extended", ext.nq),
                  ("theoretical_velocity_from_extended", ext.nv)):
        x = rng.normal(size=(3, n))
        out = getattr(tr, fn)(torch.as_tensor(x)).numpy()
        np.testing.assert_array_equal(out, np.asarray(getattr(jr, fn)(jnp.asarray(x))), err_msg=fn)
    q_ext = tr.extended_position_from_theoretical(torch.as_tensor(th.neutral()))
    np.testing.assert_array_equal(q_ext.numpy(), ext.neutral())


def _quaternions(rng, n):
    """Random, near-identity (1e-9 to 1e-4 rad) and near-pi unit quaternions,
    with w of either sign."""
    quat = rng.normal(size=(3 * n, 4))
    axis = rng.normal(size=(2 * n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    small = 10.0 ** rng.uniform(-9.0, -4.0, size=(n, 1))
    big = np.pi - 10.0 ** rng.uniform(-8.0, -2.0, size=(n, 1))
    angle = np.concatenate([small, big])
    quat[n:] = np.concatenate([axis * np.sin(angle / 2), np.cos(angle / 2)], axis=1)
    quat[::2] *= -1.0
    return quat / np.linalg.norm(quat, axis=1, keepdims=True)


def test_jlog3_and_flexibility_torque_match_jax():
    rng = np.random.default_rng(1)
    quat = _quaternions(rng, 40)
    w_t = t_lie.log3_quat(torch.as_tensor(quat))
    w_j = j_lie.log3_quat(jnp.asarray(quat))
    _close(w_t.numpy(), w_j, 1e-12)
    _close(t_lie.jlog3(w_t).numpy(), j_lie.jlog3(w_j), 1e-12)
    tr, jr = _robots("anymal")
    m = tr.model
    q = np.tile(m.neutral(), (40, 1))
    for k, j in enumerate(tr.flexibility.joint_indices):
        q[:, m.q_slice(j)] = quat[k * 30:k * 30 + 40] if k < 3 else quat[-40:]
    v = rng.normal(size=(40, m.nv))
    u_t = t_internal.flexibility_torque(tr, torch.as_tensor(q), torch.as_tensor(v)).numpy()
    u_j = j_internal.flexibility_torque(jr, jnp.asarray(q), jnp.asarray(v))
    _close(u_t, u_j, 1e-12)
    assert np.abs(u_t).max() > 1e3  # the springs pull
    rigid = t_builders.build_anymal(False)
    assert not t_internal.flexibility_torque(rigid, torch.zeros(2, rigid.nq),
                                             torch.zeros(2, rigid.nv)).any()


@pytest.fixture(scope="module")
def envs():
    return (t_make("anymal-pid", flexible=True, device="cpu", dtype=torch.float64),
            j_make("anymal-pid", flexible=True))


def test_spherical_core_matches_jax_on_pendulum():
    """The plain core (`cdyn_accel`'s plain version) on jiminy_tpu's flexible
    pendulum, against its ABA (the ANYmal's test holds it to jiminy_tpu's
    core)."""
    tr, jr = _robots("pendulum")
    m = tr.model
    rng = np.random.default_rng(2)
    q = np.tile(m.neutral(), (8, 1))
    q[:, 0], q[:, -1] = rng.normal(size=8), rng.normal(size=8)
    qi = m.idx_q[tr.flexibility.joint_indices[0]]
    q[:, qi:qi + 4] = _quaternions(rng, 3)[:8]
    v, tau = rng.normal(size=(8, m.nv)), rng.normal(size=(8, m.nv))
    a = t_cdyn.ComponentDynamics(m, GRAV).accel(*(torch.as_tensor(x) for x in (q, v, tau)))
    qj, vj, tj = (jnp.asarray(x) for x in (q, v, tau))
    with jax.disable_jit():  # compiling jiminy_tpu's ABA costs more than running it
        for b in (0, 4):  # a random and a near-identity quaternion
            _close(a[b].numpy(), j_dyn.aba(jr.model, jnp.asarray(GRAV), qj[b], vj[b], tj[b]),
                   1e-12)


def test_spherical_core_matches_jax(envs):
    """The plain core on the flexible ANYmal's flexible states (feet in the
    ground, random and near-identity flexibility quaternions), and its
    contact outputs, against jiminy_tpu's core run eagerly."""
    t_env, j_env = envs
    tr, jr = t_env.robot, j_env.robot
    q, v, tau = (x.numpy() for x in flexible_states(t_env, 8, seed=5))
    cd = t_cdyn.ComponentDynamics(tr.model, GRAV, contact_opts=t_env.engine.options.contacts,
                                  contact_frames=tr.contact_frame_indices)
    jd = j_cdyn.ComponentDynamics(jr.model, GRAV,
                                  contact_opts=j_env.env.engine.options.contacts,
                                  contact_frames=jr.contact_frame_indices)
    qt, vt, tt = (torch.as_tensor(x) for x in (q, v, tau))
    a = cd.accel(qt, vt, tt)
    with jax.disable_jit():
        a_ref = np.asarray(jd.accel(jnp.asarray(q), jnp.asarray(v), jnp.asarray(tau)))
        _close(a.numpy(), a_ref, 1e-12)
        aux_ref = jd.aux_outputs(jnp.asarray(q), jnp.asarray(v), jnp.asarray(a_ref))
    aux = cd.aux_outputs(qt, vt, a)
    for key in ("contact_f_world", "contact_w_local", "contact_depth"):
        _close(aux[key].numpy(), aux_ref[key], 1e-12)
    assert float(aux["contact_f_world"][..., 2].max()) > 10.0  # feet in the ground


def test_contact_sensor_raws_match_jax():
    """The contact sensors' read-out (the LOCAL linear force at each foot)
    from the same contact wrenches."""
    tr, jr = _robots("anymal")
    w = np.random.default_rng(3).normal(size=(5, 4, 6))
    raw = tr.sensors.contact.compute_raw(
        tr.model, None, None, None, None, None,
        {"contact_forces_local": torch.as_tensor(w[..., 3:6])})
    ref = jr.sensors.contact.compute_raw(jr.model, None, None, None, None, None,
                                         {"contact_forces_local": jnp.asarray(w[..., 3:6])})
    np.testing.assert_allclose(raw.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def test_rk4_substep_matches_jax(envs):
    """One RK4 substep of the per-stage path (`_accel_fn` with the
    flexibility torques, the retraction), from flexible states and from the
    reset, against jiminy_tpu's component core run eagerly."""
    t_env, j_env = envs
    eng = t_env.engine
    assert eng._cdyn is not None and eng._stagewise and not eng.supports_fused_rollout
    j_eng = type(j_env.env.engine)(j_env.robot, j_env.env.engine.options.replace(
        use_fast_dynamics="always"))
    assert j_eng._cdyn is not None
    q, v, _ = flexible_states(t_env, 7, seed=7)  # 8 envs, as the core's test: shapes reused
    st, _ = t_env.reset(batch_size=1)
    q = torch.cat([q, st.sim.q])
    v = torch.cat([v, st.sim.v])
    cmd = torch.as_tensor(np.random.default_rng(8).normal(size=(8, 12)) * 0.5)
    dt = eng._dt_tick
    q1, v1, a = t_steppers.rk4_step(eng.robot.model, eng._accel_fn(cmd),
                                    torch.zeros(8, dtype=q.dtype), q, v, dt)
    with jax.disable_jit():
        ref = j_steppers.rk4_step(j_eng.robot.model, j_eng._accel_fn(jnp.asarray(cmd.numpy())),
                                  jnp.zeros(8), jnp.asarray(q.numpy()), jnp.asarray(v.numpy()),
                                  jnp.asarray(float(dt)))
    for out, r in zip((q1, v1, a), ref):
        _close(out.numpy(), np.asarray(r), 1e-10)


def _golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _unhex(x):
    return np.array([float.fromhex(s) for s in x])


@pytest.mark.parametrize("mode", ["period", "period_constraint"])
def test_resolved_period_matches_golden(mode):
    """One controller period of 2.5e-5 s substeps through `Engine.step` from
    the reset, under the golden's motor command: spring-damper (the
    per-stage core path) and constraint contact mode (the generic path: no
    kernel takes PGS rows beside SPHERICAL joints)."""
    base = t_make("anymal-pid", flexible=True, device="cpu", dtype=torch.float64).engine.options
    opts = constraint_mode_options(base) if mode == "period_constraint" else base
    env = t_make("anymal-pid", flexible=True, device="cpu", dtype=torch.float64,
                 options=resolving_options(opts))
    eng = env.engine
    assert eng.n_substeps == 4
    assert (eng._cdyn is None) == (mode == "period_constraint") and eng._cdyn_cm is None
    golden = _golden()
    st, _ = env.reset(batch_size=1)
    sim = eng.step(st.sim, torch.as_tensor(_unhex(golden["command"])))
    rec = golden[mode]
    for f in ("q", "v", "a", "contact_forces"):
        _close(getattr(sim, f).numpy().ravel(), _unhex(rec[f]), 1e-10)
    m = eng.robot.model
    deflection = max(float(sim.q[0, m.q_slice(j)][:3].abs().max())
                     for j in eng.robot.flexibility.joint_indices)
    assert deflection > 1e-9  # the motors' reaction bends the flexibility joints


def test_first_env_step_diverges_as_in_jax(envs):
    """As configured (RK4 at 1 ms) jiminy_tpu's first env step is
    non-finite in every entry of q, v and a (the golden), and so is its
    state after two controller periods; the port's state after those two
    periods is non-finite in the same entries (NaN carries through every
    later period of the step; the contact forces are zero at a NaN depth):
    their divergence, not a difference (`testing.resolving_options`)."""
    t_env, _ = envs
    golden = _golden()
    assert not any(golden["step"]["q"]) and not golden["step"]["reward"]
    st, _ = t_env.reset(batch_size=1)
    cmd = torch.as_tensor(_unhex(golden["command"]))
    sim = t_env.engine.step(t_env.engine.step(st.sim, cmd), cmd)
    for f in ("q", "v", "a", "contact_forces"):
        finite = torch.isfinite(getattr(sim, f)).numpy().ravel()
        np.testing.assert_array_equal(finite, np.asarray(golden["periods"][f]), err_msg=f)
        assert f == "contact_forces" or not finite.any()  # no contact at a NaN depth
