"""The port's constrained (PGS) path, module by module, against jiminy_tpu on
the CPU at float64: the constraint registry, component CRBA and RNEA, the
LDL^T factor and solves, the bound and contact rows, the Gauss-Seidel
sweeps, one constrained dynamics evaluation, one constrained period (one
substep) and one constrained rollout (two ticks of one substep).

The configuration is `anymal-pid` in constraint contact mode with joint
bounds through the solver (28 rows: 12 bounds, 4 contacts x 4), as
`bench.py` builds it with `BENCH_CONTACT=constraint`. Inputs come from
`jiminy_torch.testing.constrained_inputs` (numpy, seeded): feet 0-3 cm into
the ground, a quarter of the envs past a joint bound, random commands, warm
starts and active sets. jiminy_tpu runs eagerly under `jax.disable_jit()`:
compiling its constrained ANYmal graph takes minutes, an eager solve a few
seconds.

The last tests check the premises of the constrained kernels' design on the
plain version alone: the sweeps on the active rows give the full system's
multipliers, and the packed support dofs are the rows' non-zero pattern.

Tolerances: the port mirrors jiminy_tpu op for op, so CRBA, RNEA, the LDL^T
factor and the rows agree to 1e-12 absolute; the Gauss-Seidel row dot is one
reduction in the port and a sequential sum in jiminy_tpu, so everything
downstream of the sweeps is held at 1e-12 absolute plus 1e-12 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_torch.engine import solver as t_solver
from jiminy_torch.envs import make as t_make
from jiminy_torch.testing import constrained_inputs, constraint_mode_options
from jiminy_tpu.engine import config as j_config
from jiminy_tpu.engine import solver as j_solver
from jiminy_tpu.envs import make as j_make

TOL = dict(atol=1e-12, rtol=1e-12)


@pytest.fixture(scope="module")
def envs():
    """Constraint-mode anymal-pid in both packages (the port on the CPU at
    float64; jiminy_tpu with its component core forced on the CPU)."""
    t_env = t_make("anymal-pid", device="cpu", dtype=torch.float64)
    t_env = t_make("anymal-pid", device="cpu", dtype=torch.float64,
                   options=constraint_mode_options(t_env.engine.options))
    return t_env, j_make("anymal-pid", options=j_constraint_options())


def j_constraint_options(**kw):
    """jiminy_tpu's anymal-pid options in constraint mode, its component core
    on (it runs that core only off the CPU unless told to)."""
    opts = j_make("anymal-pid").env.engine.options
    return opts.replace(
        contacts=dataclasses.replace(opts.contacts, model=j_config.ContactModel.CONSTRAINT),
        joint_bounds_mode="constraint", use_fast_dynamics="always", **kw,
    )


@pytest.fixture(scope="module")
def inputs(envs):
    q, v, cmd, solver = constrained_inputs(envs[0], 4, seed=0)
    return q.numpy(), v.numpy(), cmd.numpy(), solver.numpy()


def _comps(x):
    return [x[..., i] for i in range(x.shape[-1])]


def _dense(entries, batch):
    """Nested component lists (tensors, jax arrays or Python floats) -> numpy."""
    if isinstance(entries, (list, tuple)):
        return np.stack([_dense(e, batch) for e in entries], axis=-1)
    return np.broadcast_to(np.asarray(entries, np.float64), batch)


def _components(cd_t, cd_j, q, v):
    tq, tv = _comps(torch.as_tensor(q)), _comps(torch.as_tensor(v))
    jq, jv = _comps(jnp.asarray(q)), _comps(jnp.asarray(v))
    return (cd_t, tq, tv), (cd_j, jq, jv)


def test_constraint_set_matches_jax(envs):
    t_env, j_env = envs
    tc, jc = t_env.engine.cset, j_env.env.engine.cset
    assert tc.total_rows == jc.total_rows == 28
    assert (tc.n_bounds, tc.n_contacts, tc.n_distance, tc.n_rolling) == (12, 4, 0, 0)
    assert tc.bound_joint_indices == jc.bound_joint_indices
    assert tc.contact_frame_indices == tuple(jc.contact_frame_indices)
    assert tc.contact_radii == tuple(jc.contact_radii)
    assert tc.row_offsets() == jc.row_offsets()
    assert t_env.engine._cdyn is None and t_env.engine._cdyn_cm is not None
    assert j_env.env.engine._cdyn is None and j_env.env.engine._cdyn_cm is not None
    assert t_env.engine.supports_fused_rollout and j_env.env.engine.supports_fused_rollout


def test_relaxation_schedule_matches_jax():
    for iter_max in (1, 7, 16, 50, 100):
        for it in range(iter_max):
            assert t_solver._relaxation(it, iter_max) == float(j_solver._relaxation(it, iter_max))


def test_mass_matrix_and_nle_match_jax(envs, inputs):
    t_env, j_env = envs
    q, v, _, _ = inputs
    (cd_t, tq, tv), (cd_j, jq, jv) = _components(t_env.engine._cdyn_cm,
                                                 j_env.env.engine._cdyn_cm, q, v)
    batch = q.shape[:-1]
    np.testing.assert_allclose(_dense(cd_t.mass_matrix_components(tq), batch),
                               _dense(cd_j.mass_matrix_components(jq), batch), atol=1e-12, rtol=0)
    np.testing.assert_allclose(_dense(cd_t.nle_components(tq, tv), batch),
                               _dense(cd_j.nle_components(jq, jv), batch), atol=1e-12, rtol=0)


def test_ldl_factor_and_solves_match_jax(envs, inputs):
    t_env, j_env = envs
    q, v, _, _ = inputs
    (cd_t, tq, _), (cd_j, jq, _) = _components(t_env.engine._cdyn_cm,
                                               j_env.env.engine._cdyn_cm, q, v)
    batch = q.shape[:-1]
    l_t, d_t = t_solver._ldl_factor_components(cd_t.mass_matrix_components(tq))
    l_j, d_j = j_solver._ldl_factor_components(cd_j.mass_matrix_components(jq))
    n = len(d_t)
    for i in range(n):
        for j in range(i):
            np.testing.assert_allclose(_dense(l_t[i][j], batch), _dense(l_j[i][j], batch),
                                       atol=1e-12, rtol=0)
    np.testing.assert_allclose(_dense(d_t, batch), _dense(d_j, batch), atol=1e-12, rtol=1e-14)
    # Three right-hand sides at once in the port, one at a time in jiminy_tpu
    rng = np.random.default_rng(1)
    rhs = rng.normal(size=(3, q.shape[0], n)) * 10.0
    out = t_solver._ldl_solve_components(l_t, d_t, _comps(torch.as_tensor(rhs)))
    for k in range(3):
        ref = j_solver._ldl_solve_components(l_j, d_j, _comps(jnp.asarray(rhs[k])))
        np.testing.assert_allclose(torch.stack(out, -1)[k].numpy(), _dense(ref, batch), **TOL)
    # Literal zeros (a bound row's structural zeros) are skipped alike
    row = [0.0] * n
    row[9] = torch.as_tensor(rhs[0, :, 9])
    out = t_solver._ldl_solve_components(l_t, d_t, row)
    row[9] = jnp.asarray(rhs[0, :, 9])
    ref = j_solver._ldl_solve_components(l_j, d_j, row)
    np.testing.assert_allclose(_dense(out, batch), _dense(ref, batch), **TOL)


def test_constraint_rows_match_jax(envs, inputs):
    t_env, j_env = envs
    t_eng, j_eng = t_env.engine, j_env.env.engine
    q, v, _, solver = inputs
    batch = q.shape[:-1]
    o = t_eng._solver_opts
    nb, nc, n = 12, 4, 28
    cact, bact = solver[:, n : n + nc] > 0.5, solver[:, n + nc :] > 0.5
    (cd_t, tq, tv), (cd_j, jq, jv) = _components(t_eng._cdyn_cm, j_eng._cdyn_cm, q, v)

    def run(cd, sol, qc, vc, masks, lib):
        xs = cd._joint_x(qc)
        world = cd._world_placements(xs)
        vel, acc = cd._vel_bias_components(xs, vc)
        cact_c = [lib(masks[0][:, k]) for k in range(nc)]
        bact_c = [lib(masks[1][:, k]) for k in range(nb)]
        if sol is t_solver:
            return sol.constraint_system_components(cd, t_eng.cset, qc, vc, xs, world, vel, acc,
                                                    o.kp, o.kd, o.transition_eps, cact_c, bact_c)
        return sol.constraint_system_components(cd, j_eng.cset, qc, vc, xs, world, vel, acc, None,
                                                o.kp, o.kd, o.transition_eps, cact_c, bact_c, [])

    out_t = run(cd_t, t_solver, tq, tv, (cact, bact), torch.as_tensor)
    with jax.disable_jit():
        out_j = run(cd_j, j_solver, jq, jv, (cact, bact), jnp.asarray)
    rows_t, drifts_t, basis_t, depth_t, cact_t, bact_t = out_t
    rows_j, drifts_j, basis_j, depth_j, cact_j, bact_j = out_j
    np.testing.assert_allclose(_dense(rows_t, batch), _dense(rows_j, batch), atol=1e-12, rtol=0)
    np.testing.assert_allclose(_dense(drifts_t, batch), _dense(drifts_j, batch), atol=1e-12,
                               rtol=1e-13)
    np.testing.assert_allclose(_dense(depth_t, batch), _dense(depth_j, batch), atol=1e-15, rtol=0)
    np.testing.assert_array_equal(_dense(basis_t, batch), _dense(basis_j, batch))
    np.testing.assert_array_equal(_dense(cact_t, batch), _dense(cact_j, batch))
    np.testing.assert_array_equal(_dense(bact_t, batch), _dense(bact_j, batch))
    # The linear point Jacobian columns of a foot (the loop-closure rows' building block)
    fidx = t_eng.cset.contact_frame_indices[0]
    parent = t_env.robot.model.frame_parents[fidx]
    cols = []
    for cd, qc in ((cd_t, tq), (cd_j, jq)):
        world = cd._world_placements(cd._joint_x(qc))
        rw, pw = world[parent]
        fp = cd.c.fpos[fidx]
        pc = [sum(rw[i][k] * fp[k] for k in range(3)) + pw[i] for i in range(3)]
        cols.append(cd._point_jacobian_cols(world, parent, pc))
    assert sorted(cols[0]) == sorted(cols[1]) == [0, 1, 2, 3, 4, 5, 6, 7, 8]
    for d in cols[0]:
        np.testing.assert_allclose(_dense(cols[0][d], batch), _dense(cols[1][d], batch),
                                   atol=1e-12, rtol=0)
    # The inputs exercise both sides of the hysteresis
    assert 0 < _dense(cact_t, batch).mean() < 1 and 0 < _dense(bact_t, batch).mean() < 1
    assert _dense(depth_t, batch).min() < 0.0


@pytest.mark.parametrize("friction,torsion", [(1.0, 0.0), (0.7, 0.05), (0.0, 0.0)])
def test_pgs_sweeps_match_jax(envs, friction, torsion):
    cset = envs[0].engine.cset
    n = cset.total_rows
    rng = np.random.default_rng(2)
    g = rng.normal(size=(3, n, n))
    a = g @ np.swapaxes(g, -1, -2) / n + np.eye(n) * 0.5  # SPD, diagonally weighted
    b = rng.normal(size=(3, n)) * 20.0
    lam0 = np.abs(rng.normal(size=(3, n))) * 5.0
    out = t_solver._pgs_sweep_components(
        cset, torch.as_tensor(np.moveaxis(a, 0, -1)), torch.as_tensor(b.T),
        torch.as_tensor(lam0.T), friction, torsion, 16,
    )
    cset_j = envs[1].env.engine.cset
    assert cset_j.total_rows == n
    with jax.disable_jit():
        ref = j_solver._pgs_sweep_components(
            cset_j,
            [[jnp.asarray(a[:, i, j]) for j in range(n)] for i in range(n)],
            _comps(jnp.asarray(b)), _comps(jnp.asarray(lam0)), friction, torsion, 16, jnp.float64,
        )
    np.testing.assert_allclose(out.T.numpy(), _dense(ref, (3,)), **TOL)
    # Projections hold: bounds and normals >= 0, tangents inside the cone
    lam = out.T.numpy()
    off_c = cset.n_bounds
    assert (lam[:, :off_c] >= 0).all() and (lam[:, off_c + 2 :: 4] >= 0).all()
    lt = np.hypot(lam[:, off_c::4], lam[:, off_c + 1 :: 4])
    assert (lt <= friction * lam[:, off_c + 2 :: 4] * (1 + 1e-12) + 1e-12).all()


def _solver_args(o):
    return (o.kp, o.kd, o.transition_eps, o.friction, o.torsion, o.regularization, o.iter_max)


def test_constrained_accel_matches_jax(envs, inputs):
    t_env, j_env = envs
    t_eng, j_eng = t_env.engine, j_env.env.engine
    q, v, cmd, solver = inputs
    n, nc = 28, 4
    tau = np.zeros_like(v)
    tau[:, 6:] = cmd
    o = t_eng._solver_opts
    lam, cact, bact = solver[:, :n], solver[:, n : n + nc] > 0.5, solver[:, n + nc :] > 0.5
    out = t_solver.constrained_accel_full_components(
        t_eng._cdyn_cm, t_eng.cset, *(_comps(torch.as_tensor(x)) for x in (q, v, tau)),
        *_solver_args(o), _comps(torch.as_tensor(cact)), _comps(torch.as_tensor(bact)),
        _comps(torch.as_tensor(lam)),
    )
    with jax.disable_jit():
        ref = j_solver.constrained_accel_full_components(
            j_eng._cdyn_cm, j_eng.cset, *(_comps(jnp.asarray(x)) for x in (q, v, tau)), None,
            *_solver_args(o), _comps(jnp.asarray(cact)), _comps(jnp.asarray(bact)), [],
            _comps(jnp.asarray(lam)), jnp.float64,
        )
    batch = q.shape[:-1]
    np.testing.assert_allclose(_dense(out[0], batch), _dense(ref[0], batch), **TOL)
    np.testing.assert_allclose(out[1].T.numpy(), _dense(ref[1], batch), **TOL)
    for k in (4, 5):  # active sets
        np.testing.assert_array_equal(_dense(out[k], batch), _dense(ref[k], batch))
    assert np.abs(out[1].numpy()).max() > 1.0  # the multipliers are not all zero


def test_constrained_period_matches_jax(envs, inputs):
    """One constrained period of one RK4 substep, stage-chained warm start."""
    t_env, j_env = envs
    t_eng, j_eng = t_env.engine, j_env.env.engine
    q, v, cmd, solver = inputs
    cc = np.concatenate([cmd, solver], axis=1)
    o = t_eng._solver_opts
    out = t_eng._get_period_run("rk4").plain(*map(torch.as_tensor, (q, v, cc)), n_substeps=1)
    j_run = j_solver.make_constrained_period_integrator(
        j_eng._cdyn_cm, j_eng._build_tau_c(), {}, 1e-3, 1, "rk4", j_eng.cset, None,
        *_solver_args(o), n_cmd=12, imu_frames=j_eng._imu_frames, stage_warm_start=True,
    )
    with jax.disable_jit():
        ref = j_run(*map(jnp.asarray, (q, v, cc)))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert out[2].shape == (4, 108)


def test_constrained_rollout_matches_jax(envs, inputs):
    """One constrained env step cut to two ticks of one substep: the PD
    block in the loop, the end-of-tick warm-start refresh after the first
    tick, none after the last."""
    t_env, j_env = envs
    t_eng, j_eng = t_env.engine, j_env.env.engine
    q, v, cmd, solver = inputs
    block = np.concatenate([q[:, 7:], np.zeros((4, 24))], axis=1)
    carry = np.concatenate([block, solver], axis=1)
    action = cmd * 2.5
    o = t_eng._solver_opts
    t_ctrl = t_env.block.component_controller(t_env.env)
    run = t_eng._get_rollout_run("pd", t_ctrl, 8)
    out = run.plain(*map(torch.as_tensor, (q, v, action, carry)), n_ticks=2, n_substeps=1)
    j_fn, n_block = j_env.block.component_controller(j_env.env)
    j_run = j_solver.make_constrained_rollout_integrator(
        j_eng._cdyn_cm, j_eng._build_tau_c(), {}, 1e-3, 1, "rk4", j_eng.cset, None,
        *_solver_args(o), 12, 2, j_fn, n_block, 12, imu_frames=j_eng._imu_frames,
        stage_warm_start=True,
    )
    with jax.disable_jit():
        ref = j_run(*map(jnp.asarray, (q, v, action, carry)))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert out[2].shape == (4, 108 + 56 + 80)


# --------------------------------------------------------------------------- #
# The premises of the constrained kernels' design (csrc/pgs.cuh): inactive
# rows can be left out of the solve, and a row's sums can run over its
# support dofs alone.
# --------------------------------------------------------------------------- #


def _states(t_env, kind):
    """(q, v, lam, cact, bact) at float64: `constrained_inputs` states with
    mixed, all or no active rows, or standing at rest."""
    n, nc = t_env.engine.cset.total_rows, t_env.engine.cset.n_contacts
    q, v, _, sol = constrained_inputs(t_env, 6, seed=7, rows=kind)
    return q, v, sol[:, :n], sol[:, n:n + nc] > 0.5, sol[:, n + nc:] > 0.5


@pytest.mark.parametrize("kind", ["mixed", "standing", "none", "all"])
def test_sweeps_on_the_active_rows_alone_match_the_full_system(envs, kind, monkeypatch):
    """The plain sweeps on the active sub-system (inactive rows and columns
    of A and b removed) give the full system's active multipliers, and the
    full system keeps every inactive multiplier at exactly 0. Both sides run
    torch's sum, whose grouping of terms depends on their count, so the
    active multipliers are held to rounding (1e-13 of the largest), not to
    the bit; the kernels' own sums drop the same exact zeros."""
    t_env = envs[0]
    eng = t_env.engine
    cset = eng.cset
    nb, nc = cset.n_bounds, cset.n_contacts
    q, v, lam, cact, bact = _states(t_env, kind)
    seen = {}
    plain_sweeps = t_solver._pgs_sweep_components

    def spy(cs, a, b, lam0, friction, torsion, iter_max):
        seen.update(a=a, b=b, lam0=lam0, args=(friction, torsion, iter_max))
        return plain_sweeps(cs, a, b, lam0, friction, torsion, iter_max)

    monkeypatch.setattr(t_solver, "_pgs_sweep_components", spy)
    o = eng._solver_opts
    out = t_solver.constrained_accel_full_components(
        eng._cdyn_cm, cset, _comps(q), _comps(v), _comps(torch.zeros_like(v)), *_solver_args(o),
        _comps(cact), _comps(bact), _comps(lam),
    )
    cact_new, bact_new = torch.stack(out[4], -1), torch.stack(out[5], -1)
    full = out[1]
    counts = []
    for e in range(q.shape[0]):
        bsel = [k for k in range(nb) if bact_new[e, k]]
        csel = [k for k in range(nc) if cact_new[e, k]]
        rows = bsel + [nb + 4 * k + j for k in csel for j in range(4)]
        counts.append(len(rows))
        inactive = [r for r in range(cset.total_rows) if r not in rows]
        assert bool((full[inactive, e] == 0).all())
        if not rows:
            continue
        sub = dataclasses.replace(
            cset, bound_joint_indices=tuple(cset.bound_joint_indices[k] for k in bsel),
            contact_frame_indices=tuple(cset.contact_frame_indices[k] for k in csel),
            contact_radii=tuple(cset.contact_radii[k] for k in csel),
        )
        idx = torch.tensor(rows)
        a, b, lam0 = (seen[k][..., e] for k in ("a", "b", "lam0"))
        x = plain_sweeps(sub, a[idx][:, idx], b[idx], lam0[idx], *seen["args"])
        scale = float(full[:, e].abs().max())
        np.testing.assert_allclose(x.numpy(), full[idx, e].numpy(), rtol=0, atol=1e-13 * scale)
    if kind == "none":
        assert max(counts) == 0
    elif kind == "all":
        assert min(counts) == cset.total_rows
    elif kind == "standing":
        assert counts == [4 * nc] * len(counts)
    else:
        assert 0 < max(counts) < cset.total_rows


@pytest.mark.parametrize("kind", ["mixed", "standing", "none", "all"])
def test_packed_supports_match_the_rows_nonzero_pattern(envs, kind):
    """`pack_constraints` packs each contact's support dofs (its parent
    joint's and ancestors' dofs, ascending): exactly the entries of its four
    plain rows that are not Python 0.0; a bound row's one entry is its dof."""
    t_env = envs[0]
    eng = t_env.engine
    cset, cd = eng.cset, eng._cdyn_cm
    nb = cset.n_bounds
    q, v, _, cact, bact = _states(t_env, kind)
    qc, vc = _comps(q), _comps(v)
    xs = cd._joint_x(qc)
    world = cd._world_placements(xs)
    vel, acc = cd._vel_bias_components(xs, vc)
    o = eng._solver_opts
    rows = t_solver.constraint_system_components(cd, cset, qc, vc, xs, world, vel, acc, o.kp, o.kd,
                                                 o.transition_eps, _comps(cact), _comps(bact))[0]
    si = t_solver.pack_constraints(cd, cset, o, "cpu", torch.float64).si.tolist()
    head = t_solver.SI_HEADER
    for k in range(nb):
        assert [d for d, x in enumerate(rows[k]) if not t_solver._lit0(x)] == [si[head + 2 * k + 1]]
    for k in range(cset.n_contacts):
        parent, n_sup, off = si[head + 2 * nb + 3 * k : head + 2 * nb + 3 * k + 3]
        assert parent == t_env.robot.model.frame_parents[cset.contact_frame_indices[k]]
        sup = si[off : off + n_sup]
        assert sup == t_solver.support_dofs(cd, parent) and len(sup) == 9
        for r in range(4):
            row = rows[nb + 4 * k + r]
            assert [d for d, x in enumerate(row) if not t_solver._lit0(x)] == sup
