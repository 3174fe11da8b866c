"""The port's Cassie/Digit slice against jiminy_tpu on the CPU at float64:
the collision meshes and their oriented boxes, the two robots as
`envs.assets.load_robot` builds them, the loop-closure rows (generic and
component), jiminy_tpu's two Cassie-shaped four-bar test models through the
constrained core (loop rows beside spring-damper contacts and penalty
bounds), the ANYmal's joint-bound rows beside its spring-damper contacts,
and the env ids this slice opens.

Inputs come from `jiminy_torch.testing.loop_inputs` (numpy, seeded). The
component functions mirror jiminy_tpu op for op (1e-12 of their scale); a
period passes through the Gauss-Seidel sweeps, whose row dot is one
reduction in the port and a sequential sum in jiminy_tpu (1e-10). jiminy_tpu
runs its component path eagerly under `jax.disable_jit()`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_torch.engine.engine import Engine as TEngine
from jiminy_torch.engine import constraints as t_constraints
from jiminy_torch.engine import solver as t_solver
from jiminy_torch.envs import assets as t_assets
from jiminy_torch.envs import make as t_make
from jiminy_torch.models import urdf as t_urdf
from jiminy_torch.ops import integrate as t_integ
from jiminy_torch.ops.kinematics import forward_kinematics as t_fk
from jiminy_torch.ops.kinematics import joint_space_jacobian as t_jac
from jiminy_torch.testing import fourbar_options, fourbar_robot, loop_inputs
from jiminy_tpu.engine import Engine as JEngine
from jiminy_tpu.engine import EngineOptions as JOptions
from jiminy_tpu.engine import Robot as JRobot
from jiminy_tpu.engine import constraints as j_constraints
from jiminy_tpu.engine import solver as j_solver
from jiminy_tpu.engine.config import ContactOptions as JContactOptions
from jiminy_tpu.engine.config import StepperOptions as JStepperOptions
from jiminy_tpu.envs import assets as j_assets
from jiminy_tpu.envs import make as j_make
from jiminy_tpu.models import urdf as j_urdf
from jiminy_tpu.models.joints import JointType as JJointType
from jiminy_tpu.models.model import build_model as j_build_model
from jiminy_tpu.ops.kinematics import forward_kinematics as j_fk
from jiminy_tpu.ops.kinematics import joint_space_jacobian as j_jac

ATOL = 1e-12


def _comps(x):
    return [x[..., i] for i in range(x.shape[-1])]


def _dense(entries, batch):
    """Nested component lists (tensors, jax arrays or Python floats) -> numpy."""
    if isinstance(entries, (list, tuple)):
        return np.stack([_dense(e, batch) for e in entries], axis=-1)
    return np.broadcast_to(np.asarray(entries, np.float64), batch)


def _close(a, b, rel):
    """Within `rel` of the larger operand's scale."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1.0)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale)


# --------------------------------------------------------------------------- #
# Meshes and robots
# --------------------------------------------------------------------------- #

MESHES = [("cassie", "toe.stl"), ("cassie", "toe_mirror.stl"), ("digit", "toe-roll.obj")]


@pytest.mark.parametrize("robot,mesh", MESHES)
def test_mesh_vertices_and_oriented_box_match_jax(robot, mesh):
    path = f"{t_assets.robot_data_dir(robot)}/meshes/{mesh}"
    verts = t_urdf.load_mesh_vertices(path)
    ref = j_urdf.load_mesh_vertices(path)
    np.testing.assert_array_equal(verts, ref)
    assert verts.shape[0] > 8
    scaled = t_urdf.load_mesh_vertices(path, np.array([1.0, 2.0, 0.5]))
    np.testing.assert_array_equal(scaled, j_urdf.load_mesh_vertices(path, np.array([1.0, 2.0, 0.5])))
    box = t_urdf.oriented_bounding_box(verts)
    np.testing.assert_allclose(box, j_urdf.oriented_bounding_box(ref), rtol=0, atol=ATOL)
    # The box holds the cloud: every vertex inside, to rounding
    axes = box[[4, 2, 1]] - box[0]
    local = np.linalg.solve(axes.T, (verts - box[0]).T).T
    assert local.min() > -1e-9 and local.max() < 1 + 1e-9


@pytest.fixture(scope="module")
def robots():
    return {name: (t_assets.load_robot(name), j_assets.load_robot(name))
            for name in ("cassie", "digit")}


@pytest.mark.parametrize("name,nq,nv,nm", [("cassie", 21, 18, 10), ("digit", 27, 26, 20)])
def test_robot_matches_jax(robots, name, nq, nv, nm):
    t_robot, j_robot = robots[name]
    tm, jm = t_robot.model, j_robot.model
    assert (tm.nq, tm.nv, t_robot.nmotors) == (jm.nq, jm.nv, j_robot.nmotors) == (nq, nv, nm)
    assert tm.joint_names == tuple(jm.joint_names)
    assert tuple(tm.joint_types) == tuple(int(t) for t in jm.joint_types)
    for locked in t_assets._LOCKED_JOINTS[name]:
        assert locked not in tm.joint_names
    assert tm.frame_names == tuple(jm.frame_names)
    assert tm.frame_parents == tuple(jm.frame_parents)
    np.testing.assert_allclose(tm.fplacement_rot, np.asarray(jm.fplacement_rot), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tm.fplacement_pos, np.asarray(jm.fplacement_pos), rtol=0, atol=ATOL)
    for frame, _, _ in t_assets._PUSHRODS[name]:
        assert frame in tm.frame_names
    # Eight contact points, four a toe, in the reference's order and places
    assert t_robot.contact_frame_indices == tuple(j_robot.contact_frame_indices)
    assert len(t_robot.contact_frame_indices) == 8
    assert t_robot.motors.names == tuple(j_robot.motors.names)
    np.testing.assert_allclose(tm.armature, np.asarray(jm.armature), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tm.damping, np.asarray(jm.damping), rtol=0, atol=ATOL)
    assert t_robot.loop_pairs == tuple(tuple(p) for p in j_robot.loop_pairs)
    assert len(t_robot.loop_pairs) == 2
    np.testing.assert_array_equal(t_assets.nominal_pose(name, tm),
                                  j_assets.nominal_pose(name, jm))


def test_digit_carries_across_from_arrays(robots):
    """jiminy_tpu's Digit through `convert.robot_from_arrays` (model and
    motor arrays, contact frames, loop pairs): the constrained core of the
    port's `digit-pid` engine built on it gives the own robot's evaluation
    to the bit."""
    from jiminy_torch import convert
    from jiminy_torch.engine.hardware import MOTOR_ARRAY_FIELDS
    from jiminy_torch.models.model import ARRAY_FIELDS, META_FIELDS

    t_robot, j_robot = robots["digit"]
    model = {f: getattr(j_robot.model, f) for f in META_FIELDS}
    model.update({f: np.asarray(getattr(j_robot.model, f)) for f in ARRAY_FIELDS})
    motors = {f: getattr(j_robot.motors, f) for f in convert.MOTOR_META_FIELDS}
    motors.update({f: np.asarray(getattr(j_robot.motors, f)) for f in MOTOR_ARRAY_FIELDS})
    robot = convert.robot_from_arrays(model, motors, name="digit",
                                      contact_frames=j_robot.contact_frame_indices,
                                      loop_pairs=j_robot.loop_pairs)
    assert robot.contact_frame_indices == t_robot.contact_frame_indices
    assert robot.loop_pairs == t_robot.loop_pairs
    opts = t_make("digit", device="cpu", dtype=torch.float64).engine.options
    own = TEngine(t_robot, opts, device="cpu", dtype=torch.float64)
    carried = TEngine(robot, opts, device="cpu", dtype=torch.float64)
    q, v, cmd, tail = loop_inputs(own, t_assets.nominal_pose("digit", t_robot.model), 2, seed=9)
    q[:, 2] += 0.9
    cc = _comps(torch.cat([cmd, tail], dim=-1))
    a_own = own._get_period_run("rk4").accel(_comps(q), _comps(v), cc)
    a_car = carried._get_period_run("rk4").accel(_comps(q), _comps(v), cc)
    _close(_dense(a_car[0], (2,)), _dense(a_own[0], (2,)), 1e-13)
    _close(a_car[1].numpy(), a_own[1].numpy(), 1e-13)


# --------------------------------------------------------------------------- #
# The four-bar models, both packages
# --------------------------------------------------------------------------- #


def _j_fourbar(contacts):
    """jiminy_tpu's four-bar test robot, from the port's joint specs."""
    t_robot = fourbar_robot(contacts)
    m = t_robot.model
    joints = []
    for j in range(m.njoints):
        spec = {
            "name": m.joint_names[j], "type": JJointType.REVOLUTE, "parent": m.parents[j],
            "axis": np.asarray(m.joint_axes[j]),
            "placement": (np.asarray(m.jplacement_rot[j]), np.asarray(m.jplacement_pos[j])),
            "mass": float(m.mass[j]), "com": np.asarray(m.com[j]),
            "inertia": np.asarray(m.inertia[j]),
        }
        if np.isfinite(m.position_limit_upper[j]):
            spec["position_limit"] = (np.array([m.position_limit_lower[j]]),
                                      np.array([m.position_limit_upper[j]]))
        joints.append(spec)
    frames = [{"name": m.frame_names[f], "parent": m.frame_parents[f],
               "placement": (np.asarray(m.fplacement_rot[f]), np.asarray(m.fplacement_pos[f]))}
              for f in range(len(m.frame_names)) if m.frame_names[f] in ("tip_a", "tip_b", "foot")]
    model = j_build_model(m.name, joints, frames)
    return JRobot.build(model, motors=[{"joint_name": "j0"}],
                        contact_frames=["foot"] if contacts else [],
                        loop_constraints=[("tip_a", "tip_b")])


def _j_fourbar_options(contacts, fast):
    base = dict(stepper=JStepperOptions(dt_max=1e-3), use_fast_dynamics=fast)
    if contacts:
        base.update(contacts=JContactOptions(stiffness=2e4, damping=4e2, friction=1.0),
                    joint_bounds_mode="penalty")
    return JOptions(**base)


FOURBAR_Q0 = {False: [0.3, -0.2, 0.1], True: [0.4, -0.3, 0.2]}


@pytest.fixture(scope="module", params=[False, True], ids=["fourbar", "fourbar_c"])
def fourbars(request):
    contacts = request.param
    t_eng = TEngine(fourbar_robot(contacts), fourbar_options(contacts), device="cpu",
                    dtype=torch.float64)
    j_eng = JEngine(_j_fourbar(contacts), _j_fourbar_options(contacts, "always"))
    return contacts, t_eng, j_eng


def _j_core(j_eng, n_substeps=1):
    """jiminy_tpu's constrained period closures for its engine."""
    o = j_eng.options
    omega = 2.0 * np.pi * o.contacts.stabilization_freq
    return j_solver.make_constrained_period_integrator(
        j_eng._cdyn_cm, j_eng._build_tau_c(), {} if j_eng.constraint_mode else j_eng._bound_gains,
        j_eng.tick_period / j_eng.n_substeps, n_substeps, "rk4", j_eng.cset, None,
        omega * omega, 2.0 * omega, o.contacts.transition_eps, o.contacts.friction,
        o.contacts.torsion, o.stepper.pgs_regularization, o.stepper.pgs_iter_max,
        n_cmd=j_eng.robot.nmotors, imu_frames=j_eng._imu_frames,
        stage_warm_start=o.stepper.pgs_stage_warm_start, _return_core=True,
    )


def test_fourbar_engines_match_jax(fourbars):
    contacts, t_eng, j_eng = fourbars
    assert t_eng._cdyn_cm is not None and j_eng._cdyn_cm is not None
    assert t_eng.cset.n_distance == j_eng.cset.n_distance == 1
    assert t_eng.cset.n_contacts == 0 and t_eng.cset.row_offsets() == j_eng.cset.row_offsets()
    assert t_eng._cdyn_cm.contact_frames == tuple(j_eng._cdyn_cm.contact_frames)
    assert t_eng._cdyn_cm.has_contacts == contacts
    tg, jg = t_eng._bound_gains, j_eng._bound_gains  # CRBA diagonals: to rounding
    assert set(tg) == set(jg) and all(tg[k] == pytest.approx(jg[k], rel=1e-13) for k in tg)
    assert bool(t_eng._bound_gains) == contacts
    assert t_eng.supports_fused_rollout


def test_fourbar_rows_and_accel_match_jax(fourbars):
    """The loop row and drift, its length at the reset pose, and one
    constrained evaluation of the core (spring-damper foot and penalty
    bound beside the row in `fourbar_c`) within 1e-12 of their scale."""
    contacts, t_eng, j_eng = fourbars
    q, v, cmd, tail = loop_inputs(t_eng, FOURBAR_Q0[contacts], 6, seed=1)
    q[:2, 0] = 1.2  # past the bound
    cc = torch.cat([cmd, tail], dim=-1)
    batch = q.shape[:-1]
    kin_t = t_fk(t_eng.robot.model, torch.as_tensor(FOURBAR_Q0[contacts], dtype=torch.float64))
    kin_j = j_fk(j_eng.robot.model, jnp.asarray(FOURBAR_Q0[contacts]))
    np.testing.assert_allclose(
        t_constraints.compute_distance_refs(t_eng.robot.model, t_eng.cset, kin_t).numpy(),
        np.asarray(j_constraints.compute_distance_refs(j_eng.robot.model, j_eng.cset, kin_j)),
        rtol=0, atol=ATOL)
    cd_t, cd_j = t_eng._cdyn_cm, j_eng._cdyn_cm
    o = t_eng._solver_opts
    dref = tail[:, :1]
    rows = []
    for cd, qc, vc, d in ((cd_t, _comps(q), _comps(v), [dref[:, 0]]),
                          (cd_j, _comps(jnp.asarray(q.numpy())), _comps(jnp.asarray(v.numpy())),
                           [jnp.asarray(dref[:, 0].numpy())])):
        xs = cd._joint_x(qc)
        world = cd._world_placements(xs)
        vel, acc = cd._vel_bias_components(xs, vc)
        if cd is cd_t:
            rows.append(cd.distance_rows_components(world, vel, acc, t_eng.cset.distance_pairs,
                                                    d, o.kp, o.kd))
        else:
            rows.append(cd.distance_rows_components(xs, world, vel, acc,
                                                    j_eng.cset.distance_pairs, d, o.kp, o.kd))
    _close(_dense(rows[0][0], batch), _dense(rows[1][0], batch), ATOL)
    _close(_dense(rows[0][1], batch), _dense(rows[1][1], batch), ATOL)
    core = _j_core(j_eng)
    out = t_eng._get_period_run("rk4").accel(_comps(q), _comps(v), _comps(cc))
    with jax.disable_jit():
        ref = core["accel"](_comps(jnp.asarray(q.numpy())), _comps(jnp.asarray(v.numpy())),
                            _comps(jnp.asarray(cc.numpy())), jnp.float64)
    _close(_dense(out[0], batch), _dense(ref[0], batch), ATOL)
    _close(out[1].T.numpy(), _dense(ref[1], batch), ATOL)
    assert float(np.abs(out[1].numpy()).max()) > 1e-3  # the loop carries a force


def test_fourbar_period_matches_jax(fourbars):
    """One constrained period of one RK4 substep and its extras."""
    contacts, t_eng, j_eng = fourbars
    q, v, cmd, tail = loop_inputs(t_eng, FOURBAR_Q0[contacts], 6, seed=2)
    cc = torch.cat([cmd, tail], dim=-1)
    out = t_eng._get_period_run("rk4").plain(q, v, cc, n_substeps=1)
    core = _j_core(j_eng)
    with jax.disable_jit():
        qc, vc, ccl = core["substep"](_comps(jnp.asarray(q.numpy())),
                                      _comps(jnp.asarray(v.numpy())),
                                      _comps(jnp.asarray(cc.numpy())))
        extras = core["final_outputs"](qc, vc, ccl)
    batch = q.shape[:-1]
    for got, ref in zip(out, (qc, vc, extras)):
        _close(got.numpy(), _dense(ref, batch), 1e-10)
    assert out[2].shape[-1] == core["n_extra"]


@pytest.mark.parametrize("contacts", [False, True], ids=["fourbar", "fourbar_c"])
def test_fourbar_component_path_matches_generic_path(contacts):
    """The port's component core against its own generic path (generic
    kinematics, Jacobians and the array-form PGS), as jiminy_tpu's tests hold
    its two paths: 40 controller periods from the same state."""
    robot, opts = fourbar_robot(contacts), fourbar_options(contacts)
    core = TEngine(robot, opts, device="cpu", dtype=torch.float64)
    generic = TEngine(robot, opts.replace(use_fast_dynamics=False), device="cpu",
                      dtype=torch.float64)
    assert core._cdyn_cm is not None and generic._cdyn_cm is None and generic._cdyn is None
    q0 = torch.tensor(FOURBAR_Q0[contacts], dtype=torch.float64)
    st_c, st_g = core.reset(q0), generic.reset(q0)
    torch.testing.assert_close(st_c.distance_ref, st_g.distance_ref, rtol=0, atol=ATOL)
    torch.testing.assert_close(st_c.a, st_g.a, rtol=0, atol=1e-9)
    u = torch.tensor([2.0 if contacts else 0.5], dtype=torch.float64)
    for _ in range(40):
        st_c, st_g = core.step(st_c, u), generic.step(st_g, u)
    torch.testing.assert_close(st_c.q, st_g.q, rtol=0, atol=1e-9)
    torch.testing.assert_close(st_c.v, st_g.v, rtol=0, atol=1e-8)
    if contacts:
        assert float(st_c.q[0]) < 1.15  # the penalty bound holds


# --------------------------------------------------------------------------- #
# Generic loop rows on Cassie; the ANYmal's bound rows beside its springs
# --------------------------------------------------------------------------- #


def test_cassie_generic_distance_rows_match_jax():
    t_eng = t_make("cassie", device="cpu", dtype=torch.float64).engine
    assert t_eng._cdyn is None and t_eng._cdyn_cm is None  # its ankles are continuous
    j_eng = j_make("cassie").engine
    t_robot, j_robot = t_eng.robot, j_eng.robot
    q0 = t_assets.nominal_pose("cassie", t_robot.model)
    q, v, _, tail = loop_inputs(t_eng, q0, 4, seed=3)
    q = t_integ.normalize(t_robot.model, q)
    nd = t_eng.cset.n_distance
    nb, nc = t_eng.cset.n_bounds, t_eng.cset.n_contacts
    batch = q.shape[:-1]
    tm, jm = t_robot.model, j_robot.model
    kin_t = t_fk(tm, q, v, torch.zeros_like(v))
    kin_j = j_fk(jm, jnp.asarray(q.numpy()), jnp.asarray(v.numpy()), jnp.zeros(v.shape))
    none_t = torch.zeros(batch + (0,), dtype=torch.bool)
    csys_t = t_constraints.compute_constraint_system(
        tm, t_eng.cset, t_eng.options.contacts, None, kin_t, t_jac(tm, kin_t), q, v,
        none_t, none_t, distance_ref=tail[:, :nd])
    csys_j = j_constraints.compute_constraint_system(
        jm, j_eng.cset, j_eng.options.contacts, None, kin_j, j_jac(jm, kin_j),
        jnp.asarray(q.numpy()), jnp.asarray(v.numpy()), jnp.zeros(batch + (0,), bool),
        jnp.zeros(batch + (0,), bool), distance_ref=jnp.asarray(tail[:, :nd].numpy()))
    assert (nb, nc, nd) == (0, 0, 2)
    _close(csys_t.jac.numpy(), np.asarray(csys_j.jac), ATOL)
    _close(csys_t.drift.numpy(), np.asarray(csys_j.drift), ATOL)
    assert bool(csys_t.active.all())
    np.testing.assert_allclose(
        t_constraints.compute_distance_refs(tm, t_eng.cset, kin_t).numpy(),
        np.asarray(j_constraints.compute_distance_refs(jm, j_eng.cset, kin_j)), rtol=0, atol=ATOL)


def test_anymal_bound_rows_beside_springs_period_matches_jax():
    """anymal-pid with its joint bounds through the solver beside its
    spring-damper feet (`joint_bounds_mode="constraint"`): one constrained
    period of one RK4 substep within 1e-10."""
    from jiminy_torch.testing import constrained_inputs

    base = t_make("anymal-pid", device="cpu", dtype=torch.float64)
    t_env = t_make("anymal-pid", device="cpu", dtype=torch.float64,
                   options=base.engine.options.replace(joint_bounds_mode="constraint"))
    t_eng = t_env.engine
    j_opts = j_make("anymal-pid").env.engine.options
    j_env = j_make("anymal-pid", options=j_opts.replace(joint_bounds_mode="constraint",
                                                        use_fast_dynamics="always"))
    j_eng = j_env.env.engine
    assert t_eng._cdyn_cm.has_contacts and j_eng._cdyn_cm.contact_frames
    assert (t_eng.cset.n_bounds, t_eng.cset.n_contacts) == (12, 0)
    q, v, cmd, sol = constrained_inputs(t_env, 4, seed=4)
    cc = torch.cat([cmd, sol], dim=-1)
    out = t_eng._get_period_run("rk4").plain(q, v, cc, n_substeps=1)
    core = _j_core(j_eng)
    with jax.disable_jit():
        qc, vc, ccl = core["substep"](_comps(jnp.asarray(q.numpy())),
                                      _comps(jnp.asarray(v.numpy())),
                                      _comps(jnp.asarray(cc.numpy())))
        extras = core["final_outputs"](qc, vc, ccl)
    batch = q.shape[:-1]
    for got, ref in zip(out, (qc, vc, extras)):
        _close(got.numpy(), _dense(ref, batch), 1e-10)
    # the feet push (spring-damper forces in the extras), the bounds hold
    assert float(out[2][:, 18:30].abs().max()) > 1.0
    assert float(out[2][:, -12:].max()) == 1.0


# --------------------------------------------------------------------------- #
# Env ids and what stays refused
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name,action", [("cassie", 10), ("cassie-pid", 10), ("digit", 20),
                                         ("digit-pid", 20)])
def test_biped_env_ids_build_and_reset(name, action):
    env = t_make(name, device="cpu", dtype=torch.float64)
    assert env.action_size == action
    st, _ = env.reset(batch_size=2)
    assert st.sim.distance_ref.shape == (2, 2) and bool((st.sim.distance_ref > 0.1).all())
    assert bool(torch.isfinite(st.sim.a).all())
    digit = name.startswith("digit")
    assert (env.engine._cdyn_cm is not None) == digit  # Cassie's ankles: the generic path
    assert env.engine.supports_fused_rollout == digit


def test_unported_biped_options_raise_not_implemented():
    """The procedural builders are ported (the ant's too): each env builds
    the robot jiminy_tpu builds, the procedural Cassie the constrained core
    where the URDF one takes the generic path (no continuous joint); rolling
    rows beside a four-bar's loop pack for the kernels' extended body, the
    rolling block after the loop's."""
    for name in ("ant", "cassie-pid", "digit"):
        t_env = t_make(name, device="cpu", procedural=True)
        j_env = j_make(name, procedural=True)
        t_model, j_model = t_env.robot.model, j_env.robot.model
        assert t_model.joint_names == tuple(j_model.joint_names)
        np.testing.assert_array_equal(t_model.jplacement_pos, np.asarray(j_model.jplacement_pos))
        assert t_env.robot.loop_pairs == tuple(j_env.robot.loop_pairs)
        engine = t_env.env.engine if hasattr(t_env, "env") else t_env.engine
        assert (engine._cdyn_cm is not None) == (name != "ant")
    eng = TEngine(fourbar_robot(True), fourbar_options(True), device="cpu", dtype=torch.float64)
    for cset, wheel in (
        (dataclasses.replace(eng.cset, sphere_specs=((2, 0.02),)), 0),
        (dataclasses.replace(eng.cset, wheel_specs=((2, 0.02, (0.0, 1.0, 0.0)),)), 1),
    ):
        cpk = t_solver.pack_constraints(eng._cdyn_cm, cset, eng._solver_opts, "cpu",
                                        torch.float64)
        assert (cpk.counts["nd_rows"], cpk.counts["nr_rows"]) == (1, 1)
        assert cpk.counts["n_rows"] == cset.total_rows == 4
        si = cpk.si.tolist()
        rolling = si[t_solver.SI_HEADER + t_solver.SI_DISTANCE:][:t_solver.SI_ROLLING]
        assert rolling[0] == eng.robot.model.frame_parents[2] and rolling[3] == wheel
        assert si[rolling[2]:rolling[2] + rolling[1]] == t_solver.support_dofs(
            eng._cdyn_cm, rolling[0])
