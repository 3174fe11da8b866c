"""The port's ant (`make("ant")`: the reference's ant.urdf and hardware file,
nine sphere contacts) against jiminy_tpu on the CPU at float64.

- The robot as `envs.assets.load_robot("ant")` builds it: frames, parents,
  placements and the spheres' radii (1e-12).
- The spring-damper core (accelerations, contact forces) on seeded states
  with spheres in the ground and joints past their bounds (1e-12).
- Constraint contact mode (every sphere four PGS rows, taken at its
  surface point): the constrained evaluation's rows, drifts, active sets
  and multipliers within 1e-12 of their scale, and one RK4 substep of a
  period within 1e-10 (the Gauss-Seidel row dot is one reduction in the
  port, a sequential sum in jiminy_tpu), on flat and rough ground.
  jiminy_tpu runs its component path eagerly under `jax.disable_jit()` with
  `use_fast_dynamics="always"`.
- The first env step of `make("ant")` in both contact modes, with a seeded
  action, against jiminy_tpu's (tests/goldens_torch/ant_first_step.json,
  written by tests/goldens_torch/generate.py) within 1e-10.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_torch.engine import solver as t_solver
from jiminy_torch.engine.config import ContactModel as TContactModel
from jiminy_torch.envs import assets as t_assets
from jiminy_torch.envs import make as t_make
from jiminy_torch.testing import constrained_inputs, perturbed_states
from jiminy_torch.utils import terrain as tt
from jiminy_tpu.engine import solver as j_solver
from jiminy_tpu.engine.config import ContactModel as JContactModel
from jiminy_tpu.envs import assets as j_assets
from jiminy_tpu.envs import make as j_make
from jiminy_tpu.ops import cdyn as j_cdyn
from jiminy_tpu.utils import terrain as jt

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens_torch", "ant_first_step.json")
ANT_ACTION = np.random.default_rng(12).uniform(-1.0, 1.0, size=8)  # as generate.py draws it


def rough(mod):
    return mod.sum_heightmaps([
        mod.random_perlin_ground(wavelength=1.5, height_max=0.05, seed=3),
        mod.periodic_stairs_ground(0.4, 0.03, 3, orientation=0.5),
    ])


def _close(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1.0) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale)


def _comps(x):
    return [x[..., i] for i in range(x.shape[-1])]


def _dense(entries, batch):
    if isinstance(entries, (list, tuple)):
        return np.stack([_dense(e, batch) for e in entries], axis=-1)
    return np.broadcast_to(np.asarray(entries, np.float64), batch)


def test_ant_robot_matches_jax():
    tr, jr = t_assets.load_robot("ant"), j_assets.load_robot("ant")
    tm, jm = tr.model, jr.model
    assert (tm.nq, tm.nv, tm.njoints, tr.nmotors) == (15, 14, 9, 8)
    assert tm.frame_names == tuple(jm.frame_names)
    assert tuple(tm.frame_parents) == tuple(jm.frame_parents)
    np.testing.assert_allclose(tm.fplacement_pos, np.asarray(jm.fplacement_pos), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tm.fplacement_rot, np.asarray(jm.fplacement_rot), rtol=0, atol=1e-12)
    assert tr.contact_frame_indices == tuple(jr.contact_frame_indices)
    assert tr.contact_radii == tuple(jr.contact_radii)
    assert tr.contact_radii == (0.25,) + (0.08,) * 8
    assert tr.motors.names == tuple(jr.motors.names)


@pytest.fixture(scope="module")
def spring():
    return t_make("ant", device="cpu", dtype=torch.float64), j_make("ant")


def test_ant_spring_core_matches_jax(spring):
    """The core's accelerations (ABA, penalty bounds, nine sphere contacts
    at their surface points) and contact outputs."""
    t_env, j_env = spring
    eng = t_env.engine
    assert eng._cdyn is not None and eng.supports_fused_rollout
    assert eng.n_substeps == 5 and t_env.n_ctrl_per_step == 10
    robot = j_env.robot
    ref_core = j_cdyn.ComponentDynamics(
        robot.model, (0.0, 0.0, -9.81), contact_opts=j_env.engine.options.contacts,
        contact_frames=robot.contact_frame_indices, contact_radii=robot.contact_radii,
        bound_gains=j_env.engine._bound_gains)
    q, v, tau = perturbed_states(t_env, 8, seed=4)
    q[:, 2] -= 0.02  # more spheres in the ground
    qj, vj, tj = (jnp.asarray(x.numpy()) for x in (q, v, tau))
    a = eng._cdyn.accel(q, v, tau)
    a_ref = np.asarray(ref_core.accel(qj, vj, tj))
    np.testing.assert_allclose(a.numpy(), a_ref, atol=1e-12, rtol=1e-12)
    aux = eng._cdyn.aux_outputs(q, v, a)
    aux_ref = ref_core.aux_outputs(qj, vj, jnp.asarray(a_ref))
    for key in ("contact_f_world", "contact_w_local", "contact_depth"):
        np.testing.assert_allclose(aux[key].numpy(), np.asarray(aux_ref[key]), atol=1e-12,
                                   rtol=1e-12, err_msg=key)
    assert float(aux["contact_f_world"][..., 2].max()) > 10.0  # the spheres touch


def _j_core(j_eng):
    o = j_eng.options
    omega = 2.0 * np.pi * o.contacts.stabilization_freq
    return j_solver.make_constrained_period_integrator(
        j_eng._cdyn_cm, j_eng._build_tau_c(), {}, j_eng.tick_period / j_eng.n_substeps, 1, "rk4",
        j_eng.cset, j_eng.ground_fn, omega * omega, 2.0 * omega, o.contacts.transition_eps,
        o.contacts.friction, o.contacts.torsion, o.stepper.pgs_regularization,
        o.stepper.pgs_iter_max, n_cmd=j_eng.robot.nmotors, imu_frames=j_eng._imu_frames,
        stage_warm_start=o.stepper.pgs_stage_warm_start, _return_core=True,
    )


@pytest.mark.parametrize("ground", ["flat", "rough"])
def test_ant_constrained_evaluation_and_substep_match_jax(ground):
    """Constraint mode: 36 contact rows (the spheres'), no bound row. One
    constrained evaluation (rows, drifts, active sets, multipliers) on
    spheres 1-31 mm deep, and on rough ground one RK4 substep of a period
    with its extras (jiminy_tpu's eager substep takes some 40 s here)."""
    t_opts = t_make("ant", device="cpu", dtype=torch.float64,
                    contact_model=TContactModel.CONSTRAINT).engine.options
    j_opts = j_make("ant", contact_model=JContactModel.CONSTRAINT).engine.options
    if ground == "rough":
        t_opts = t_opts.replace(world=dataclasses.replace(t_opts.world, ground_profile=rough(tt)))
        j_opts = j_opts.replace(world=dataclasses.replace(j_opts.world, ground_profile=rough(jt)))
    t_env = t_make("ant", device="cpu", dtype=torch.float64, options=t_opts)
    j_env = j_make("ant", options=j_opts.replace(use_fast_dynamics="always"))
    t_eng, j_eng = t_env.engine, j_env.engine
    assert (t_eng.cset.n_bounds, t_eng.cset.n_contacts, t_eng.cset.total_rows) == (0, 9, 36)
    assert t_eng.cset.contact_radii == tuple(j_eng.cset.contact_radii)
    assert t_eng._cdyn_cm.bound_gains == {} and j_eng._cdyn_cm is not None
    q, v, cmd, sol = constrained_inputs(t_env, 2, seed=5)
    if ground == "rough":  # lifted by the ground's height under the base
        h, _ = t_opts.world.ground_profile(q[:, :2])
        q[:, 2] += h
    cc = torch.cat([cmd, sol], dim=-1)
    run = t_eng._get_period_run("rk4")
    core = _j_core(j_eng)
    qj, vj, ccj = (_comps(jnp.asarray(x.numpy())) for x in (q, v, cc))
    out = run.accel(_comps(q), _comps(v), _comps(cc))
    with jax.disable_jit():
        ref = core["accel"](qj, vj, ccj, jnp.float64)
    batch = q.shape[:-1]
    _close(_dense(out[0], batch), _dense(ref[0], batch), 1e-12)  # accelerations
    _close(out[1].T.numpy(), _dense(ref[1], batch), 1e-12)  # multipliers
    _close(_dense(out[3], batch), _dense(ref[3], batch), 1e-12)  # depths
    assert [bool(x) for a in out[4] for x in a.reshape(-1)] == [
        bool(x) for a in ref[4] for x in np.asarray(a).reshape(-1)]  # contact active sets
    assert any(bool(x.any()) for x in out[4]) and float(out[1].abs().max()) > 1.0
    # the rows and drifts themselves
    cd_t, cd_j, o = t_eng._cdyn_cm, j_eng._cdyn_cm, run.opts
    no_t = [torch.zeros(batch, dtype=torch.bool)] * 9
    no_j = [jnp.zeros(batch, bool)] * 9
    xs_t, xs_j = cd_t._joint_x(_comps(q)), cd_j._joint_x(qj)
    w_t, w_j = cd_t._world_placements(xs_t), cd_j._world_placements(xs_j)
    vel_t, acc_t = cd_t._vel_bias_components(xs_t, _comps(v))
    rows_t = t_solver.constraint_system_components(
        cd_t, t_eng.cset, _comps(q), _comps(v), xs_t, w_t, vel_t, acc_t, o.kp, o.kd,
        o.transition_eps, no_t, [])
    with jax.disable_jit():
        vel_j, acc_j = cd_j._vel_bias_components(xs_j, vj)
        rows_j = j_solver.constraint_system_components(
            cd_j, j_eng.cset, qj, vj, xs_j, w_j, vel_j, acc_j, j_eng.ground_fn, o.kp, o.kd,
            o.transition_eps, no_j, [], [], [])
    _close(_dense(rows_t[0], batch), _dense(rows_j[0], batch), 1e-12)
    _close(_dense(rows_t[1], batch), _dense(rows_j[1], batch), 1e-12)

    if ground == "flat":
        return
    got = run.plain(q, v, cc, n_substeps=1)
    with jax.disable_jit():
        qc, vc, ccl = core["substep"](qj, vj, ccj)
        extras = core["final_outputs"](qc, vc, ccl)
    for g, r in zip(got, (qc, vc, extras)):
        _close(g.numpy(), _dense(r, batch), 1e-10)


@pytest.mark.parametrize("mode", ["spring_damper", "constraint"])
def test_ant_first_step_matches_jax(mode):
    """make("ant"): reset one env, one env step (10 controller ticks of 5 RK4
    substeps) with a seeded action, against jiminy_tpu's."""
    kw = {} if mode == "spring_damper" else {"contact_model": TContactModel.CONSTRAINT}
    env = t_make("ant", device="cpu", dtype=torch.float64, **kw)
    st, _ = env.reset()
    st, _, reward, term, _, _ = env.step(st, torch.as_tensor(ANT_ACTION))
    with open(GOLDEN) as f:
        ref = json.load(f)[mode]
    for field in ("q", "v", "a", "contact_forces", "lam"):
        want = np.array([float.fromhex(x) for x in ref[field]])
        got = getattr(st.sim, field)
        got = np.zeros(0) if got is None else got.numpy().ravel()
        assert got.shape == want.shape, field
        _close(got, want, 1e-10)
    assert float(reward) == pytest.approx(float.fromhex(ref["reward"]), abs=1e-10)
    assert not bool(term)
