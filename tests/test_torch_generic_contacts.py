"""The generic path's contacts and constraints against jiminy_tpu on the
CPU at float64, on ANYmal states with active contacts and joints past their
bounds (`testing.constrained_inputs`): the spring-damper ground forces
(`engine/contact.py`), the bound and contact rows
(`compute_constraint_system`), the array-form PGS solve
(`constrained_forward_dynamics`, warm-started, with and without external
forces) and its two sweep forms; and the toy robots carried across
(`convert.robot_from_arrays`).

These outputs carry stiff springs (forces up to some 3e4 N on these states,
where one ulp is 4e-12), so each is held to 1e-12 of its own scale:
max |port - jiminy_tpu| <= 1e-12 (1 + max |jiminy_tpu|), the measure of
`testing.column_errors` over the whole output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generic_checks import GRAVITY, as_np, close_scaled, model_arrays
from jiminy_torch import convert
from jiminy_torch.engine import constraints as t_cons
from jiminy_torch.engine import contact as t_contact
from jiminy_torch.engine import solver as t_solver
from jiminy_torch.envs import make as t_make
from jiminy_torch.models.model import ARRAY_FIELDS
from jiminy_torch.ops import kinematics as t_kin
from jiminy_torch.testing import constrained_inputs, constraint_mode_options
from jiminy_tpu.engine import constraints as j_cons
from jiminy_tpu.engine import contact as j_contact
from jiminy_tpu.engine import solver as j_solver
from jiminy_tpu.ops import kinematics as j_kin


@pytest.fixture(scope="module")
def anymal():
    from jiminy_tpu.envs import make as j_make

    t_env = t_make("anymal-pid", device="cpu", dtype=torch.float64)
    cm_env = t_make("anymal-pid", device="cpu", dtype=torch.float64,
                    options=constraint_mode_options(t_env.engine.options))
    q, v, _, sol = (x.numpy() for x in constrained_inputs(cm_env, 8, seed=3))
    j_robot = j_make("anymal-pid").env.robot
    return t_env, cm_env, j_robot, q, v, sol


def _kins(t_env, j_robot, q, v):
    zero = np.zeros_like(v)
    tk = t_kin.forward_kinematics(t_env.robot.model, *(torch.as_tensor(x) for x in (q, v, zero)))
    jk = j_kin.forward_kinematics(j_robot.model, *(jnp.asarray(x) for x in (q, v, zero)))
    return tk, jk


def test_contact_forces_match_jax(anymal):
    t_env, _, j_robot, q, v, _ = anymal
    tk, jk = _kins(t_env, j_robot, q, v)
    opts = t_env.engine.options.contacts
    got = t_contact.compute_contact_forces(t_env.robot.model, opts, None, tk,
                                           t_env.robot.contact_frame_indices)
    want = j_contact.compute_contact_forces(j_robot.model, opts, None, jk,
                                            j_robot.contact_frame_indices)
    assert float(np.abs(got[1].numpy()).max()) > 10.0  # feet pushed into the ground
    for g_, w_, name in zip(got, want, ("fext", "f_world", "w_local", "depth")):
        close_scaled(g_, w_, msg=name)


def _j_cset(cset):
    return j_cons.ConstraintSet(
        bound_joint_indices=cset.bound_joint_indices,
        contact_frame_indices=cset.contact_frame_indices,
        contact_radii=cset.contact_radii,
    )


def _systems(anymal):
    t_env, cm_env, j_robot, q, v, sol = anymal
    cset = cm_env.engine.cset
    n, nc = cset.total_rows, cset.n_contacts
    lam, cact, bact = sol[:, :n], sol[:, n:n + nc] > 0.5, sol[:, n + nc:] > 0.5
    tk, jk = _kins(t_env, j_robot, q, v)
    opts = cm_env.engine.options.contacts
    tm, jm = cm_env.robot.model, j_robot.model
    tsys = t_cons.compute_constraint_system(
        tm, cset, opts, None, tk, t_kin.joint_space_jacobian(tm, tk), torch.as_tensor(q),
        torch.as_tensor(v), torch.as_tensor(cact), torch.as_tensor(bact))
    jsys = j_cons.compute_constraint_system(
        jm, _j_cset(cset), opts, None, jk, j_kin.joint_space_jacobian(jm, jk), jnp.asarray(q),
        jnp.asarray(v), jnp.asarray(cact), jnp.asarray(bact))
    return tsys, jsys, lam


def test_constraint_system_matches_jax(anymal):
    tsys, jsys, _ = _systems(anymal)
    assert bool(tsys.contact_active.any()) and bool(tsys.bound_active.any())
    assert not bool(tsys.active.all())
    for f in tsys._fields:
        close_scaled(getattr(tsys, f), getattr(jsys, f), msg=f)


@pytest.mark.parametrize("with_fext", [False, True], ids=["no_fext", "fext"])
def test_constrained_forward_dynamics_matches_jax(anymal, with_fext):
    t_env, cm_env, j_robot, q, v, _ = anymal
    tsys, jsys, lam = _systems(anymal)
    cset = cm_env.engine.cset
    o = cm_env.engine._solver_opts
    rng = np.random.default_rng(5)
    tau = rng.normal(size=v.shape) * 30.0
    fext = rng.normal(size=q.shape[:1] + (cm_env.robot.model.njoints, 6)) if with_fext else None
    got = t_solver.constrained_forward_dynamics(
        cm_env.robot.model, torch.as_tensor(GRAVITY), torch.as_tensor(q), torch.as_tensor(v),
        torch.as_tensor(tau), None if fext is None else torch.as_tensor(fext), tsys, cset,
        torch.as_tensor(lam), o.friction, o.torsion, o.regularization, o.iter_max)
    want = j_solver.constrained_forward_dynamics(
        j_robot.model, jnp.asarray(GRAVITY), jnp.asarray(q), jnp.asarray(v), jnp.asarray(tau),
        None if fext is None else jnp.asarray(fext), jsys, _j_cset(cset), jnp.asarray(lam),
        o.friction, o.torsion, o.regularization, o.iter_max)
    assert float(np.abs(got.lam.numpy()).max()) > 1.0
    close_scaled(got.lam, want.lam, msg="lam")
    close_scaled(got.qdd, want.qdd, msg="qdd")


def test_pgs_solve_forms_agree(anymal):
    """The array sweep and the component sweep of `pgs_solve` take the same
    rows in the same order."""
    _, cm_env, *_ = anymal
    tsys, _, lam = _systems(anymal)
    cset, o = cm_env.engine.cset, cm_env.engine._solver_opts
    rng = np.random.default_rng(6)
    n = cset.total_rows
    m = rng.normal(size=(8, n, n))
    a = torch.as_tensor(m @ m.transpose(0, 2, 1) + n * np.eye(n))
    b = torch.as_tensor(rng.normal(size=(8, n)) * 10.0)
    args = (cset, a, b, torch.as_tensor(lam), o.friction, o.torsion, o.iter_max)
    close_scaled(t_solver.pgs_solve(*args), t_solver.pgs_solve(*args, componentwise=True))


def test_toy_robots_carry_across():
    """A toy robot's model and motor bank (`Robot.build(model, motors=...)`)
    through `convert.robot_from_arrays` against the port's own."""
    from jiminy_torch.engine.hardware import MOTOR_ARRAY_FIELDS
    from jiminy_tpu.envs import make as j_make

    for env_id in ("cartpole", "acrobot", "pendulum"):
        jr = j_make(env_id).robot
        motors = {f: getattr(jr.motors, f) for f in convert.MOTOR_META_FIELDS}
        motors.update({f: as_np(getattr(jr.motors, f)) for f in MOTOR_ARRAY_FIELDS})
        robot = convert.robot_from_arrays(model_arrays(jr.model), motors, name=env_id)
        own = t_make(env_id, device="cpu", dtype=torch.float64).robot
        for f in ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(robot.model, f), getattr(own.model, f), err_msg=f)
        for f in MOTOR_ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(robot.motors, f), getattr(own.motors, f), err_msg=f)
        assert robot.motors.v_indices == own.motors.v_indices
