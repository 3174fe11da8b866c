"""`digit-pid` and `cassie-pid` end to end on the CPU at float64.

Digit runs the constrained core: its two pushrod loop closures as PGS rows
beside eight spring-damper toe contacts and penalty joint bounds, the core
jiminy_tpu builds with `use_fast_dynamics="always"` (its TPU default). One
constrained evaluation near the nominal pose with the toes touching is held
to jiminy_tpu's within 1e-12 of its scale, and one RK4 substep of a
`digit-pid` period at B=2 within 1e-10 (the Gauss-Seidel row dot is one
reduction in the port, a sequential sum in jiminy_tpu). jiminy_tpu runs its
component path eagerly under `jax.disable_jit()`.

Cassie's ankles are continuous joints, so it runs the generic path on both
packages (generic kinematics, spring-damper contacts, penalty bounds, the
array-form PGS over its two loop rows). Its golden, tests/goldens/cassie-pid.csv
(zero actions, one env, from jiminy_tpu's generic path), is held at 1e-10:
the first two rows in tier 1, all twelve in the slow tier.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_configs import read_golden
from jiminy_torch.envs import make as t_make
from jiminy_torch.testing import loop_inputs
from jiminy_tpu.engine import solver as j_solver
from jiminy_tpu.envs import make as j_make

GOLDEN_ATOL = 1e-10


def _comps(x):
    return [x[..., i] for i in range(x.shape[-1])]


def _dense(entries, batch):
    if isinstance(entries, (list, tuple)):
        return np.stack([_dense(e, batch) for e in entries], axis=-1)
    return np.broadcast_to(np.asarray(entries, np.float64), batch)


def _close(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(float(np.abs(b).max()), 1.0))


@pytest.fixture(scope="module")
def digit():
    t_env = t_make("digit-pid", device="cpu", dtype=torch.float64)
    j_env = j_make("digit-pid")
    j_opts = j_env.env.engine.options.replace(use_fast_dynamics="always")
    return t_env, j_make("digit-pid", options=j_opts)


def _j_core(j_eng, n_substeps=1):
    o = j_eng.options
    omega = 2.0 * np.pi * o.contacts.stabilization_freq
    return j_solver.make_constrained_period_integrator(
        j_eng._cdyn_cm, j_eng._build_tau_c(), j_eng._bound_gains,
        j_eng.tick_period / j_eng.n_substeps, n_substeps, "rk4", j_eng.cset, None,
        omega * omega, 2.0 * omega, o.contacts.transition_eps, o.contacts.friction,
        o.contacts.torsion, o.stepper.pgs_regularization, o.stepper.pgs_iter_max,
        n_cmd=j_eng.robot.nmotors, imu_frames=j_eng._imu_frames,
        stage_warm_start=o.stepper.pgs_stage_warm_start, _return_core=True,
    )


def test_digit_engine_matches_jax(digit):
    t_env, j_env = digit
    t_eng, j_eng = t_env.engine, j_env.env.engine
    assert t_eng._cdyn is None and t_eng._cdyn_cm is not None and j_eng._cdyn_cm is not None
    assert (t_eng.cset.n_bounds, t_eng.cset.n_contacts, t_eng.cset.n_distance) == (0, 0, 2)
    assert t_eng.cset.distance_pairs == j_eng.cset.distance_pairs
    assert t_eng._cdyn_cm.contact_frames == tuple(j_eng._cdyn_cm.contact_frames)
    assert len(t_eng._cdyn_cm.contact_frames) == 8
    tg, jg = t_eng._cdyn_cm.bound_gains, j_eng._bound_gains  # CRBA diagonals: to rounding
    assert set(tg) == set(jg) and all(tg[k] == pytest.approx(jg[k], rel=1e-13) for k in tg)
    assert len(t_eng._bound_gains) == 20
    assert t_eng.n_substeps == 5 and t_eng.tick_period == 2.5e-3
    assert t_eng.supports_fused_rollout and j_eng.supports_fused_rollout
    np.testing.assert_array_equal(t_env.block.kp, np.asarray(j_env.block.kp))
    np.testing.assert_array_equal(t_env.block.kd, np.asarray(j_env.block.kd))
    np.testing.assert_allclose(t_env.env.nominal_q.numpy(), np.asarray(j_env.env.nominal_q),
                               rtol=0, atol=1e-15)


def test_digit_constrained_accel_matches_jax(digit):
    """One evaluation of the constrained core near the nominal pose, the toes
    0-3 cm into the ground: the loop rows beside the toes' spring-damper
    forces and the penalty bounds."""
    t_env, j_env = digit
    t_eng = t_env.engine
    q, v, cmd, tail = loop_inputs(t_eng, t_env.env.nominal_q.numpy(), 3, seed=11)
    cc = torch.cat([cmd, tail], dim=-1)
    out = t_eng._get_period_run("rk4").accel(_comps(q), _comps(v), _comps(cc))
    core = _j_core(j_env.env.engine)
    with jax.disable_jit():
        ref = core["accel"](_comps(jnp.asarray(q.numpy())), _comps(jnp.asarray(v.numpy())),
                            _comps(jnp.asarray(cc.numpy())), jnp.float64)
    batch = q.shape[:-1]
    _close(_dense(out[0], batch), _dense(ref[0], batch), 1e-12)
    _close(out[1].T.numpy(), _dense(ref[1], batch), 1e-12)
    # The toes touch: their forces reach the dynamics
    cd = t_eng._cdyn_cm
    fw = cd._contact_fext(cd._world_placements(cd._joint_x(_comps(q))),
                          cd._vel_bias_components(cd._joint_x(_comps(q)), _comps(v))[0])[1]
    assert max(float(torch.stack(f).abs().max()) for f in fw) > 1.0


def test_digit_pid_period_substep_matches_jax(digit):
    """One RK4 substep of a `digit-pid` controller period and its
    end-of-period extras at B=2."""
    t_env, j_env = digit
    t_eng = t_env.engine
    q, v, cmd, tail = loop_inputs(t_eng, t_env.env.nominal_q.numpy(), 2, seed=12)
    cc = torch.cat([cmd, tail], dim=-1)
    out = t_eng._get_period_run("rk4").plain(q, v, cc, n_substeps=1)
    core = _j_core(j_env.env.engine)
    with jax.disable_jit():
        qc, vc, ccl = core["substep"](_comps(jnp.asarray(q.numpy())),
                                      _comps(jnp.asarray(v.numpy())),
                                      _comps(jnp.asarray(cc.numpy())))
        extras = core["final_outputs"](qc, vc, ccl)
    batch = q.shape[:-1]
    for got, ref in zip(out, (qc, vc, extras)):
        _close(got.numpy(), _dense(ref, batch), 1e-10)
    assert out[2].shape[-1] == core["n_extra"]


def _cassie_rows(n_rows: int):
    env = t_make("cassie-pid", device="cpu", dtype=torch.float64)
    st, _ = env.reset()
    action = torch.zeros(env.action_size, dtype=torch.float64)
    rows = []
    for _ in range(n_rows):
        st, _, reward, _, _, _ = env.step(st, action)
        sim = st.sim
        rows.append(np.concatenate([[float(sim.t)], sim.q.numpy(), sim.v.numpy(),
                                    [float(reward)], sim.contact_forces.numpy().ravel()]))
    return np.stack(rows)


def test_cassie_pid_reproduces_golden_rows():
    golden = read_golden("cassie-pid")
    np.testing.assert_allclose(_cassie_rows(2), golden[:2], atol=GOLDEN_ATOL, rtol=0)


@pytest.mark.slow
def test_cassie_pid_reproduces_all_golden_rows():
    golden = read_golden("cassie-pid")
    np.testing.assert_allclose(_cassie_rows(len(golden)), golden, atol=GOLDEN_ATOL, rtol=0)
