"""The Atlas in constraint mode (`atlas-reduced-pid` and `atlas-pid` with
`testing.constraint_mode_options`: ground contacts and joint bounds as PGS
rows, as bench.py's BENCH_CONTACT=constraint builds them) and the ant with
its joint bounds as rows, against jiminy_tpu on the CPU at float64.

- The constraint sets: 12 + 12 x 4 = 60 and 30 + 12 x 4 = 78 rows, the bound
  joints and contact frames jiminy_tpu picks, and the packed layout the
  constrained kernels read (`pack_constraints`): its header, each bound's
  (q, v) indices, each contact's support dofs (its frame's ancestor dofs in
  jiminy_tpu's model, 12 at most).
- One constrained evaluation (accelerations, multipliers, depths, active
  sets) within 1e-12 of its scale, on two states from
  `testing.constrained_inputs` (seed 21): `atlas-reduced-pid` against
  jiminy_tpu's component core run here eagerly (`jax.disable_jit()`,
  `use_fast_dynamics="always"`: some 15 s), `atlas-pid` against the same
  core's numbers stored in tests/goldens_torch/atlas_cm_first_step.json (its
  eager evaluation takes some 35 s here; `generate.py` writes the file).
- One RK4 substep of a period and its extras within 1e-10, against the
  stored numbers of jiminy_tpu's core (the Gauss-Seidel row dot is one
  reduction in the port, a sequential sum in jiminy_tpu).
- The first controller period from the reset through `Engine.step` (the PD
  block's first command; the feet not yet down) within 1e-10 of jiminy_tpu's
  engine, stored.
- The ant with its bounds as rows: 36 sphere rows and 8 bound rows, its rows
  and drifts against jiminy_tpu's run here (1e-12), one evaluation and one
  substep against the stored numbers (1e-12, 1e-10).
- Slow tier: the first env step (16 ticks of 5 RK4 substeps, 336 solves;
  1.5 and 4 minutes of plain torch here) against jiminy_tpu's, stored.
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
from jiminy_torch.envs import make as t_make
from jiminy_torch.testing import constrained_inputs, constraint_mode_options
from jiminy_tpu.engine import solver as j_solver
from jiminy_tpu.engine.config import ContactModel as JContactModel
from jiminy_tpu.envs import make as j_make
from jiminy_tpu.ops.kinematics import ancestor_dof_mask

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens_torch", "atlas_cm_first_step.json")
IDS = ("atlas-reduced-pid", "atlas-pid")
ROWS = {"atlas-reduced-pid": (12, 12, 60), "atlas-pid": (30, 12, 78)}  # bounds, contacts, rows
STATE_FIELDS = ("q", "v", "a", "contact_forces", "lam")


def _close(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1.0) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale)


def _comps(x):
    return [x[..., i] for i in range(x.shape[-1])]


def _dense(entries, batch):
    if isinstance(entries, (list, tuple)):
        return np.stack([_dense(e, batch) for e in entries], axis=-1)
    return np.broadcast_to(np.asarray(entries, np.float64), batch)


def _unhex(x):
    return np.asarray(float.fromhex(x)) if isinstance(x, str) else np.stack([_unhex(r) for r in x])


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _t_env(name):
    base = t_make(name, device="cpu", dtype=torch.float64).engine.options
    return t_make(name, device="cpu", dtype=torch.float64, options=constraint_mode_options(base))


def _j_env(name, **kw):
    o = j_make(name).env.engine.options
    return j_make(name, options=o.replace(
        contacts=dataclasses.replace(o.contacts, model=JContactModel.CONSTRAINT),
        joint_bounds_mode="constraint", **kw))


def _t_ant_bounds():
    opts = t_make("ant", device="cpu", dtype=torch.float64,
                  contact_model=TContactModel.CONSTRAINT).engine.options
    return t_make("ant", device="cpu", dtype=torch.float64,
                  options=opts.replace(joint_bounds_mode="constraint"))


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


def _inputs(rec):
    return tuple(torch.as_tensor(_unhex(rec[k])) for k in ("q", "v", "cc"))


def _check_eval(out, ref, batch):
    """The port's `run.accel` outputs against (accel, lam, depth, cact,
    bact), each (batch, n)."""
    _close(_dense(out[0], batch), ref[0], 1e-12)  # accelerations
    _close(out[1].T.numpy(), ref[1], 1e-12)  # multipliers
    _close(_dense(out[3], batch), ref[2], 1e-12)  # depths
    for got, want in ((out[4], ref[3]), (out[5], ref[4])):  # active sets
        got = np.stack([np.broadcast_to(np.asarray(a, np.float64), batch) for a in got], -1)
        np.testing.assert_array_equal(got, np.asarray(want, np.float64))


@pytest.mark.parametrize("name", IDS)
def test_atlas_cm_rows_and_packed_layout_match_jax(name):
    t_env, j_env = _t_env(name), _j_env(name, use_fast_dynamics="always")
    t_eng, j_eng = t_env.engine, j_env.env.engine
    nb, nc, n = ROWS[name]
    tc, jc = t_eng.cset, j_eng.cset
    assert (tc.n_bounds, tc.n_contacts, tc.total_rows) == (nb, nc, n)
    assert (jc.n_bounds, jc.n_contacts, jc.total_rows) == (nb, nc, n)
    assert tc.bound_joint_indices == tuple(jc.bound_joint_indices)
    assert tc.contact_frame_indices == tuple(jc.contact_frame_indices)
    assert t_eng._cdyn_cm is not None and j_eng._cdyn_cm is not None
    assert t_eng._cdyn_cm.bound_gains == {} and t_eng.supports_fused_rollout
    assert t_env.n_ctrl_per_step == 16 and t_eng.n_substeps == 5
    run = t_eng._get_period_run("rk4")
    cpk = run.pack("cpu", torch.float64)
    si = cpk.si.tolist()
    jm = j_env.robot.model
    assert si[:8] == [n, nb, nc, run.opts.iter_max, int(run.opts.stage_warm_start), 12, 0, 0]
    assert t_solver.cm_ext(run.cd.pack(run.tau_c, run.dt, run.imu_frames, "cpu", torch.float64),
                           cpk) == 0  # the bound and contact rows' instance
    bounds = [si[8 + 2 * b: 10 + 2 * b] for b in range(nb)]
    assert bounds == [[int(jm.idx_q[j]), int(jm.idx_v[j])] for j in jc.bound_joint_indices]
    o = 8 + 2 * nb
    for k, fidx in enumerate(jc.contact_frame_indices):
        parent, count, at = si[o + 3 * k: o + 3 * k + 3]
        assert parent == jm.frame_parents[fidx]
        assert tuple(si[at:at + count]) == ancestor_dof_mask(jm, parent)
    assert len(si) == o + 3 * nc + sum(si[o + 3 * k + 1] for k in range(nc))


def test_atlas_reduced_pid_cm_evaluation_matches_jax(golden):
    """One constrained evaluation against jiminy_tpu's core run here."""
    name = "atlas-reduced-pid"
    t_env = _t_env(name)
    q, v, cmd, sol = constrained_inputs(t_env, 2, seed=21)
    cc = torch.cat([cmd, sol], dim=-1)
    for x, key in ((q, "q"), (v, "v"), (cc, "cc")):  # the stored inputs are these
        np.testing.assert_array_equal(x.numpy(), _unhex(golden[name][key]))
    out = t_env.engine._get_period_run("rk4").accel(_comps(q), _comps(v), _comps(cc))
    core = _j_core(_j_env(name, use_fast_dynamics="always").env.engine)
    qj, vj, ccj = (_comps(jnp.asarray(x.numpy())) for x in (q, v, cc))
    with jax.disable_jit():
        ref = core["accel"](qj, vj, ccj, jnp.float64)
    batch = q.shape[:-1]
    _check_eval(out, [_dense(ref[0], batch), _dense(ref[1], batch), _dense(ref[3], batch),
                      _dense([jnp.where(a, 1.0, 0.0) for a in ref[4]], batch),
                      _dense([jnp.where(a, 1.0, 0.0) for a in ref[5]], batch)], batch)
    lam = out[1]
    assert float(lam.abs().max()) > 1.0 and bool(torch.stack(out[4]).any())


@pytest.mark.parametrize("name", IDS + ("ant-bounds",))
def test_cm_evaluation_and_substep_match_stored_jax(golden, name):
    """One constrained evaluation (atlas-pid: jiminy_tpu's, stored; the
    others also run here above) and one RK4 substep with its extras."""
    t_env = _t_ant_bounds() if name == "ant-bounds" else _t_env(name)
    rec = golden[name]
    q, v, cc = _inputs(rec)
    run = t_env.engine._get_period_run("rk4")
    batch = q.shape[:-1]
    out = run.accel(_comps(q), _comps(v), _comps(cc))
    _check_eval(out, [_unhex(rec["eval"][k]) for k in ("accel", "lam", "depth", "cact", "bact")],
                batch)
    got = run.plain(q, v, cc, n_substeps=1)
    for g, key in zip(got, ("q", "v", "extras")):
        _close(g.numpy(), _unhex(rec["substep"][key]), 1e-10)
    assert got[2].shape[-1] == run.n_extra


def test_ant_bounds_as_rows_system_matches_jax():
    """The ant's 44 rows: 8 bound rows, then its nine spheres' 36 contact
    rows; the rows and drifts of jiminy_tpu's `constraint_system_components`."""
    t_env = _t_ant_bounds()
    j_opts = j_make("ant", contact_model=JContactModel.CONSTRAINT).engine.options
    j_eng = j_make("ant", options=j_opts.replace(joint_bounds_mode="constraint",
                                                 use_fast_dynamics="always")).engine
    t_eng = t_env.engine
    assert (t_eng.cset.n_bounds, t_eng.cset.n_contacts, t_eng.cset.total_rows) == (8, 9, 44)
    assert t_eng.cset.bound_joint_indices == tuple(j_eng.cset.bound_joint_indices)
    q, v, _, _ = constrained_inputs(t_env, 8, seed=23)
    batch = q.shape[:-1]
    cd_t, cd_j, o = t_eng._cdyn_cm, j_eng._cdyn_cm, t_eng._get_period_run("rk4").opts
    qj, vj = (_comps(jnp.asarray(x.numpy())) for x in (q, v))
    xs_t, xs_j = cd_t._joint_x(_comps(q)), cd_j._joint_x(qj)
    w_t, w_j = cd_t._world_placements(xs_t), cd_j._world_placements(xs_j)
    vel_t, acc_t = cd_t._vel_bias_components(xs_t, _comps(v))
    rows_t = t_solver.constraint_system_components(
        cd_t, t_eng.cset, _comps(q), _comps(v), xs_t, w_t, vel_t, acc_t, o.kp, o.kd,
        o.transition_eps, [torch.zeros(batch, dtype=torch.bool)] * 9,
        [torch.zeros(batch, dtype=torch.bool)] * 8)
    with jax.disable_jit():
        vel_j, acc_j = cd_j._vel_bias_components(xs_j, vj)
        rows_j = j_solver.constraint_system_components(
            cd_j, j_eng.cset, qj, vj, xs_j, w_j, vel_j, acc_j, j_eng.ground_fn, o.kp, o.kd,
            o.transition_eps, [jnp.zeros(batch, bool)] * 9, [jnp.zeros(batch, bool)] * 8, [], [])
    for k in (0, 1, 3):  # rows, drifts, depths
        _close(_dense(rows_t[k], batch), _dense(rows_j[k], batch), 1e-12)
    for k in (4, 5):  # contact and bound active sets
        np.testing.assert_array_equal(_dense([a.double() for a in rows_t[k]], batch),
                                      _dense([jnp.where(a, 1.0, 0.0) for a in rows_j[k]], batch))
    assert bool(torch.stack(rows_t[5]).any())  # a quarter of the states are past a bound


def _first(t_env, rec, step: bool):
    """The port's first controller period through Engine.step (or, with
    `step`, its first env step) from its reset, zero actions, against the
    stored record."""
    st, _ = t_env.reset()
    action = torch.zeros(t_env.action_size, dtype=torch.float64)
    if step:
        st, _, reward, term, _, _ = t_env.step(st, action)
        sim = st.sim
        assert not bool(term)
    else:
        cmd, _ = t_env.block.compute(action, t_env.env.observe(st), st.blocks[t_env.block.name])
        sim = t_env.env.engine.step(st.sim, cmd)
    for field in STATE_FIELDS:
        _close(getattr(sim, field).numpy().ravel(), _unhex(rec[field]), 1e-10)
    if step:
        assert float(reward) == pytest.approx(float(_unhex(rec["reward"])), abs=1e-10)
    return sim


@pytest.mark.parametrize("name", IDS)
def test_atlas_cm_first_period_matches_jax(golden, name):
    _first(_t_env(name), golden[name]["period"], step=False)


@pytest.mark.slow
@pytest.mark.parametrize("name", IDS)
def test_atlas_cm_first_step_matches_jax(golden, name):
    sim = _first(_t_env(name), golden[name]["step"], step=True)
    assert float(sim.lam.abs().max()) > 1.0  # the feet are down
