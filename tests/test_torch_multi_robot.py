"""The port's multi-robot engine (`engine/merge.py`, `engine/multi.py`)
against jiminy_tpu's at float64, and against the physics it models.

- `merge_robots` of an ANYmal, a flexible ANYmal look-alike (flexibility and
  backlash), a Cassie look-alike (loops, contact sensors) and the acrobot:
  model arrays at 1e-12, slices, motors, sensor groups and every carried
  field equal to jiminy_tpu's.
- The double spring-mass (two masses coupled by a viscoelastic spring,
  gravity off) against scipy's DOPRI at 1e-6 and jiminy_tpu at 1e-10, and
  the total momentum conserved.
- Split and merge of states with encoder and effort sensors on both robots:
  the measurements those of each robot's own engine, the round trip the
  identity.
- Each coupling (viscoelastic with a rest length and rotations, a user
  coupling, a robot-robot collision pair) one period against jiminy_tpu's
  jitted step at 1e-10 of each output's scale.
- A small forest (a free body with a contact beside the acrobot) through the
  port's component core (its plain version here) against single engines
  and against jiminy_tpu's MultiRobotEngine (its generic path: compiling
  its fused forest period takes over ten minutes on the CPU; its core takes
  the forest too) at 1e-12; the ANYmal + acrobot
  forest of `chip_smoke.py`, in both contact modes, against single engines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import ode

from generic_checks import close_scaled
from jiminy_torch.engine.config import EngineOptions as TEngineOptions
from jiminy_torch.engine.config import StepperOptions as TStepperOptions
from jiminy_torch.engine.config import WorldOptions as TWorldOptions
from jiminy_torch.engine.engine import Engine as TEngine
from jiminy_torch.engine.merge import merge_robots as t_merge_robots
from jiminy_torch.engine.multi import MultiRobotEngine as TMulti
from jiminy_torch.engine.robot import Robot as TRobot
from jiminy_torch.envs import builders as t_builders
from jiminy_torch.envs import builders_bipeds as t_bb
from jiminy_torch.envs import make as t_make
from jiminy_torch.models.model import ARRAY_FIELDS, META_FIELDS
from jiminy_torch.models.model import build_model as t_build_model
from jiminy_tpu.engine import EngineOptions as JEngineOptions
from jiminy_tpu.engine import Robot as JRobot
from jiminy_tpu.engine.config import StepperOptions as JStepperOptions
from jiminy_tpu.engine.config import WorldOptions as JWorldOptions
from jiminy_tpu.engine.merge import merge_robots as j_merge_robots
from jiminy_tpu.engine.multi import MultiRobotEngine as JMulti
from jiminy_tpu.envs import assets as j_assets
from jiminy_tpu.envs import builders as j_builders
from jiminy_tpu.envs import builders_bipeds as j_bb
from jiminy_tpu.models import JointType
from jiminy_tpu.models import build_model as j_build_model

TOL = 1e-10
PKG = {"t": (t_build_model, TRobot, TEngineOptions, TStepperOptions, TWorldOptions),
       "j": (j_build_model, JRobot, JEngineOptions, JStepperOptions, JWorldOptions)}


def t64(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def _options(pkg, gravity=(0.0, 0.0, 0.0), **kw):
    _, _, engine_opts, stepper, world = PKG[pkg]
    return engine_opts(world=world(gravity=gravity), stepper=stepper(dt_max=1e-3), **kw)


def _mass_robot(pkg, name, mass=1.0, axis=(0.0, 0.0, 1.0)):
    build_model, robot_cls = PKG[pkg][:2]
    model = build_model(name, [{"name": "pz", "type": JointType.PRISMATIC, "parent": -1,
                                "axis": np.asarray(axis, float), "mass": mass,
                                "com": np.zeros(3), "inertia": np.zeros((3, 3))}],
                        [{"name": "body", "parent": 0, "placement": (np.eye(3), np.zeros(3))}])
    return robot_cls.build(model)


def _free_body(pkg, name, mass=1.0, contact=False):
    build_model, robot_cls = PKG[pkg][:2]
    model = build_model(name, [{"name": "root", "type": JointType.FREE, "parent": -1,
                                "mass": mass, "com": np.array([0.01, 0.0, 0.02]),
                                "inertia": np.diag([2e-2, 3e-2, 4e-2])}],
                        [{"name": "body", "parent": 0,
                          "placement": (np.eye(3), np.array([0.05, 0.02, -0.1]))}])
    return robot_cls.build(model, contact_frames=("body",) if contact else ())


def _pendulum_with_sensors(pkg, name):
    build_model, robot_cls = PKG[pkg][:2]
    model = build_model(name, [{"name": "pivot", "type": JointType.REVOLUTE, "parent": -1,
                                "axis": np.array([0.0, 1.0, 0.0]), "mass": 1.0,
                                "com": np.array([0.0, 0.0, -0.5]), "inertia": np.eye(3) * 1e-3,
                                "position_limit": (np.array([-0.35]), np.array([0.45]))}])
    return robot_cls.build(model, motors=[{"joint_name": "pivot"}],
                           sensors={"encoder": [{"motor_name": "pivot"}],
                                    "effort": [{"motor_name": "pivot"}]})


# --------------------------------------------------------------------------- #


def test_merge_robots_matches_jax():
    t_robots = {"anymal": t_make("anymal-pid", device="cpu").robot,
                "flex": t_builders.build_anymal(flexible=True),
                "cassie": t_bb.build_cassie(), "acrobot": t_builders.build_acrobot()}
    j_robots = {"anymal": j_assets.load_robot("anymal"),
                "flex": j_builders.build_anymal(flexible=True),
                "cassie": j_bb.build_cassie(), "acrobot": j_builders.build_acrobot()}
    tm, t_layout = t_merge_robots(t_robots)
    jm, j_layout = j_merge_robots(j_robots)
    for mt, mj in ((tm.model, jm.model), (tm.theoretical_model, jm.theoretical_model)):
        for f in META_FIELDS:
            assert tuple(np.atleast_1d(getattr(mt, f))) == tuple(np.atleast_1d(getattr(mj, f))), f
        for f in ARRAY_FIELDS:
            np.testing.assert_allclose(getattr(mt, f), np.asarray(getattr(mj, f)), atol=1e-12,
                                       rtol=0, err_msg=f)
    assert list(t_layout) == list(j_layout)
    for name, sl in j_layout.items():
        assert vars(t_layout[name]) == vars(sl), name
    for f in ("contact_frame_indices", "contact_radii", "loop_pairs", "backlash_joint_indices",
              "rolling_specs", "collision_pairs_geom"):
        assert getattr(tm, f) == tuple(getattr(jm, f)), f
    assert tm.loop_pairs and tm.backlash_joint_indices == ()  # the look-alikes have no play
    assert tm.flexibility.joint_indices == jm.flexibility.joint_indices
    for f in ("stiffness", "damping", "inertia"):
        np.testing.assert_array_equal(getattr(tm.flexibility, f),
                                      np.asarray(getattr(jm.flexibility, f)))
    assert tm.motors.names == jm.motors.names
    for f in ("joint_indices", "v_indices", "q_indices"):
        assert getattr(tm.motors, f) == tuple(getattr(jm.motors, f)), f
    for f in ("mechanical_reduction", "armature", "effort_limit", "velocity_limit"):
        np.testing.assert_array_equal(getattr(tm.motors, f), np.asarray(getattr(jm.motors, f)))
    t_groups = dict(tm.sensors.groups())
    assert set(t_groups) == {k for k, _ in jm.sensors.groups()}
    for kind, g in jm.sensors.groups():
        tg = t_groups[kind]
        assert tg.names == g.names, kind
        for f in ("frame_indices", "motor_indices", "q_indices", "v_indices", "contact_slots"):
            if hasattr(tg, f):
                assert getattr(tg, f) == tuple(getattr(g, f)), (kind, f)


def _spring_pair(pkg, masses, k, nu, dopri=False):
    robots = {"m1": _mass_robot(pkg, "m1", masses[0]), "m2": _mass_robot(pkg, "m2", masses[1])}
    extra = {}
    if dopri:
        stepper = PKG[pkg][3]
        extra = dict(stepper=stepper(tol_abs=1e-9, tol_rel=1e-9, dt_max=5e-3))
    opts = _options(pkg, **extra) if not dopri else PKG[pkg][2](
        world=PKG[pkg][4](gravity=(0.0, 0.0, 0.0)), **extra)
    eng = (TMulti(robots, opts, device="cpu", dtype=torch.float64) if pkg == "t"
           else JMulti(robots, opts))
    eng.register_viscoelastic_coupling_force("m1", "body", "m2", "body", stiffness=k, damping=nu)
    return eng


def test_double_spring_mass_matches_scipy_and_jax():
    m1, m2, k, nu = 1.0, 2.0, 50.0, 0.5
    t_eng, j_eng = _spring_pair("t", (m1, m2), k, nu), _spring_pair("j", (m1, m2), k, nu)
    assert not t_eng.engine._use_core()  # a coupling: the generic path
    states = t_eng.reset({"m1": t64([0.0]), "m2": t64([0.3])})
    j_states = j_eng.reset({"m1": jnp.array([0.0]), "m2": jnp.array([0.3])})
    j_step = jax.jit(j_eng.step)
    ts, zs, jz = [], [], []
    for _ in range(150):  # 0.15 s, a fifth of the mode's period
        states = t_eng.step(states)
        j_states = j_step(j_states)
        ts.append(float(states["m1"].t))
        zs.append([float(states["m1"].q[0]), float(states["m2"].q[0])])
        jz.append([float(j_states["m1"].q[0]), float(j_states["m2"].q[0])])

    def f(t, y):
        z1, v1, z2, v2 = y
        fs = k * (z2 - z1) + nu * (v2 - v1)
        return [v1, fs / m1, v2, -fs / m2]

    r = ode(f).set_integrator("dopri5", rtol=1e-12, atol=1e-12)
    r.set_initial_value([0.0, 0.0, 0.3, 0.0], 0.0)
    ref = []
    for t in ts:
        r.integrate(t)
        ref.append([r.y[0], r.y[2]])
    np.testing.assert_allclose(np.array(zs), np.array(ref), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.array(zs), np.array(jz), atol=1e-10, rtol=0)


def test_momentum_conservation():
    robots = {"a": _mass_robot("t", "a", 1.0), "b": _mass_robot("t", "b", 3.0)}
    eng = TMulti(robots, _options("t"), device="cpu", dtype=torch.float64)
    eng.register_viscoelastic_coupling_force("a", "body", "b", "body", 20.0, 0.0)
    states = eng.reset({"a": t64([0.0]), "b": t64([0.5])})
    for _ in range(100):
        states = eng.step(states)
    assert abs(float(states["b"].v[0])) > 0.1
    assert abs(1.0 * float(states["a"].v[0]) + 3.0 * float(states["b"].v[0])) < 1e-9


def test_split_merge_round_trip_with_sensors():
    opts = TEngineOptions(stepper=TStepperOptions(dt_max=1e-3))
    robots = {"r1": _pendulum_with_sensors("t", "r1"), "r2": _pendulum_with_sensors("t", "r2")}
    multi = TMulti(robots, opts, device="cpu", dtype=torch.float64)
    states = multi.reset({"r1": t64([[0.3], [0.1]]), "r2": t64([[-0.2], [0.4]])})
    u = {"r1": t64([[0.5], [0.2]]), "r2": t64([[-0.5], [0.1]])}
    for _ in range(10):
        states = multi.step(states, u)
    for name, q0 in (("r1", [[0.3], [0.1]]), ("r2", [[-0.2], [0.4]])):
        single = TEngine(robots[name], opts, device="cpu", dtype=torch.float64)
        st = single.reset(t64(q0))
        for _ in range(10):
            st = single.step(st, u[name])
        for kind in ("encoder", "effort"):
            np.testing.assert_allclose(states[name].measurements[kind].numpy(),
                                       st.measurements[kind].numpy(), atol=1e-12, rtol=0)
        assert states[name].measurements["encoder"].shape == (2, 1, 2)
        assert states[name].lam.shape == (2, 1)  # its bound row
    again = multi.split_state(multi.merge_states(states))
    for name in robots:
        for f in ("q", "v", "a", "command", "u_motor", "lam", "bound_active"):
            assert torch.equal(getattr(again[name], f), getattr(states[name], f)), f
        for kind, m in states[name].measurements.items():
            assert torch.equal(again[name].measurements[kind], m)


# --------------------------------------------------------------------------- #
# The three couplings, one period against jiminy_tpu
# --------------------------------------------------------------------------- #


def _user_wrench(lib):
    """A coupling of the reference's callable form: a spring between the
    frames' origins with a torque from their velocities, either package."""
    def force_fn(t, pose1, twist1, pose2, twist2):
        (w1, v1), (w2, v2) = twist1, twist2
        p1 = pose1[1] if isinstance(pose1, tuple) else pose1.pos
        p2 = pose2[1] if isinstance(pose2, tuple) else pose2.pos
        f = 30.0 * (p2 - p1) + 0.2 * (v2 - v1)
        tau = 0.05 * (w2 - w1) + 0.01 * lib.cross(p2 - p1, v1)
        return lib.concatenate([tau, f], -1) if lib is jnp else torch.cat([tau, f], -1)
    return force_fn


def _coupled(pkg, kind):
    robots = {"a": _free_body(pkg, "a", 1.5, contact=True), "b": _free_body(pkg, "b", 2.5)}
    opts = _options(pkg, gravity=(0.0, 0.0, -9.81), controller_update_period=2e-3)
    eng = (TMulti(robots, opts, device="cpu", dtype=torch.float64) if pkg == "t"
           else JMulti(robots, opts))
    if kind == "viscoelastic":
        eng.register_viscoelastic_coupling_force("a", "body", "b", "body", 40.0, 0.7,
                                                 rest_length=0.2)
    elif kind == "generic":
        eng.register_coupling_force("a", "body", "b", "body", _user_wrench(
            torch.linalg if pkg == "t" else jnp))
    else:
        capsule = {"frame_name": "body", "geometry": "capsule", "radius": 0.06, "length": 0.2,
                   "axis": (1.0, 0.0, 0.0)}
        sphere = {"frame_name": "body", "geometry": "sphere", "radius": 0.08}
        eng.register_collision_pair("a", capsule, "b", sphere)
    return eng


@pytest.mark.parametrize("kind", ["viscoelastic", "generic", "collision"])
def test_coupling_period_matches_jax(kind):
    t_eng, j_eng = _coupled("t", kind), _coupled("j", kind)
    assert t_eng.couplings[0][0] == kind and not t_eng.engine._use_core()
    rng = np.random.default_rng({"viscoelastic": 1, "generic": 2, "collision": 3}[kind])
    qa = np.concatenate([rng.normal(size=(3, 3)) * 0.05 + [0.0, 0.0, 0.05],
                         rng.normal(size=(3, 4))], axis=1)
    qb = np.concatenate([rng.normal(size=(3, 3)) * 0.05 + [0.12, 0.02, 0.08],
                         rng.normal(size=(3, 4))], axis=1)
    for q in (qa, qb):
        q[:, 3:] /= np.linalg.norm(q[:, 3:], axis=1, keepdims=True)
    va, vb = rng.normal(size=(3, 6)) * 0.5, rng.normal(size=(3, 6)) * 0.5
    t_st = t_eng.reset({"a": t64(qa), "b": t64(qb)}, {"a": t64(va), "b": t64(vb)})
    j_st = jax.jit(jax.vmap(lambda a, b, c, d: j_eng.reset({"a": a, "b": b},
                                                           {"a": c, "b": d})))(
        jnp.asarray(qa), jnp.asarray(qb), jnp.asarray(va), jnp.asarray(vb))
    t_out = t_eng.step(t_st)
    j_out = jax.jit(jax.vmap(j_eng.step))(j_st)
    for name in ("a", "b"):
        for f in ("q", "v", "a", "contact_forces"):
            close_scaled(getattr(t_out[name], f), getattr(j_out[name], f), tol=TOL,
                         msg=f"{kind} {name} {f}")
    assert float(t_out["a"].a.abs().max()) > 1.0
