"""The procedural look-alikes (`envs/builders.build_ant`,
`envs/builders_bipeds`: Cassie, Digit, the Atlas and its reduced variant)
and their envs (`make(..., procedural=True)`) against jiminy_tpu at float64.

- Each builder's robot: model arrays at 1e-12, motors, contact frames,
  loop pairs, sensors, and the standing poses, equal to jiminy_tpu's.
- Each env: its nominal pose, PD gains, engine core and timing equal to
  jiminy_tpu's (whose component core is built with
  `use_fast_dynamics="always"`, its TPU default). The ant and the Atlas take
  the spring-damper core (the spring kernels on the card), Cassie and Digit
  the constrained core's extended body (their pushrod loop rows beside
  spring-damper toe contacts and penalty bounds; `cdyn_rollout_cm` on the
  card): the procedural Cassie has no continuous joint, unlike the URDF one.
- One RK4 substep of each env's first period, from seeded states near its
  nominal pose and seeded commands, and the period's end outputs, at 1e-10
  of their scale, jiminy_tpu's core run op by op (not jitted: compiling its
  fused substep takes minutes on the CPU).
- The whole first env step of each, in the slow tier.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_torch.envs import builders as t_builders
from jiminy_torch.envs import builders_bipeds as t_bb
from jiminy_torch.envs import make as t_make
from jiminy_torch.models.model import ARRAY_FIELDS, META_FIELDS
from jiminy_torch.testing import loop_inputs, perturbed_states
from jiminy_tpu.engine import solver as j_solver
from jiminy_tpu.envs import builders as j_builders
from jiminy_tpu.envs import builders_bipeds as j_bb
from jiminy_tpu.envs import make as j_make

TOL = 1e-10
ENVS = ("ant", "cassie-pid", "digit-pid", "atlas-pid", "atlas-reduced-pid")
BUILDERS = {
    "ant": (t_builders.build_ant, j_builders.build_ant, {}),
    "cassie": (t_bb.build_cassie, j_bb.build_cassie, {}),
    "digit": (t_bb.build_digit, j_bb.build_digit, {}),
    "atlas": (t_bb.build_atlas, j_bb.build_atlas, {}),
    "atlas-reduced": (t_bb.build_atlas, j_bb.build_atlas, {"reduced": True}),
}


def _close(got, want, rel, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(float(np.abs(want).max()), 1.0),
                               err_msg=msg)


def _comps(x):
    return [x[..., i] for i in range(x.shape[-1])]


def _dense(entries, batch):
    if isinstance(entries, (list, tuple)):
        return np.stack([_dense(e, batch) for e in entries], axis=-1)
    return np.broadcast_to(np.asarray(entries, np.float64), batch)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_robot_matches_jax(name):
    t_build, j_build, kw = BUILDERS[name]
    tr, jr = t_build(**kw), j_build(**kw)
    for f in META_FIELDS:
        assert tuple(np.atleast_1d(getattr(tr.model, f))) == tuple(
            np.atleast_1d(getattr(jr.model, f))), f
    for f in ARRAY_FIELDS:
        np.testing.assert_allclose(getattr(tr.model, f), np.asarray(getattr(jr.model, f)),
                                   rtol=0, atol=1e-12, err_msg=f)
    assert tr.motors.names == jr.motors.names
    for f in ("joint_indices", "v_indices", "q_indices"):
        assert getattr(tr.motors, f) == tuple(getattr(jr.motors, f)), f
    for f in ("mechanical_reduction", "armature", "effort_limit", "velocity_limit"):
        np.testing.assert_array_equal(getattr(tr.motors, f), np.asarray(getattr(jr.motors, f)))
    assert tr.contact_frame_indices == tuple(jr.contact_frame_indices)
    assert tr.loop_pairs == tuple(jr.loop_pairs)
    assert {k: g.names for k, g in tr.sensors.groups()} == {
        k: g.names for k, g in jr.sensors.groups()}
    poses = {"cassie": "cassie_standing_pose", "digit": "cassie_standing_pose",
             "atlas": "atlas_standing_pose", "atlas-reduced": "atlas_standing_pose"}
    if name in poses:
        np.testing.assert_array_equal(getattr(t_bb, poses[name])(tr.model),
                                      np.asarray(getattr(j_bb, poses[name])(jr.model)))


def _envs(env_id):
    """(port env, jiminy_tpu env, jiminy_tpu's engine of that env's robot and
    options with its component core)."""
    t_env = t_make(env_id, device="cpu", dtype=torch.float64, procedural=True)
    j_env = j_make(env_id, procedural=True)
    j_eng = _engine(j_env)
    return t_env, j_env, type(j_eng)(j_eng.robot, j_eng.options.replace(use_fast_dynamics="always"))


def _engine(env):
    return env.env.engine if hasattr(env, "env") else env.engine


@pytest.fixture(scope="module", params=ENVS)
def envs(request):
    return request.param, _envs(request.param)


def test_procedural_env_matches_jax(envs):
    env_id, (t_env, j_env, j_eng) = envs
    t_eng = _engine(t_env)
    t_inner = t_env.env if hasattr(t_env, "env") else t_env
    j_inner = j_env.env if hasattr(j_env, "env") else j_env
    np.testing.assert_allclose(t_inner.nominal_q.numpy(), np.asarray(j_inner.nominal_q),
                               rtol=0, atol=1e-15)
    assert (t_eng.n_substeps, t_eng.tick_period) == (j_eng.n_substeps, j_eng.tick_period)
    assert t_inner.n_ctrl_per_step == j_inner.n_ctrl_per_step
    loops = env_id.startswith(("cassie", "digit"))
    assert (t_eng._cdyn is None) == loops == (j_eng._cdyn is None)
    assert (t_eng._cdyn_cm is not None) == loops == (j_eng._cdyn_cm is not None)
    assert t_eng.supports_fused_rollout and j_eng.supports_fused_rollout
    assert t_eng.cset.distance_pairs == tuple(j_eng.cset.distance_pairs)
    assert t_eng.cset.total_rows == j_eng.cset.total_rows == (2 if loops else 0)
    tg, jg = t_eng._bound_gains, j_eng._bound_gains
    assert set(tg) == set(jg) and all(tg[k] == pytest.approx(jg[k], rel=1e-13) for k in tg)
    if hasattr(t_env, "block"):
        np.testing.assert_array_equal(t_env.block.kp, np.asarray(j_env.block.kp))
        np.testing.assert_array_equal(t_env.block.kd, np.asarray(j_env.block.kd))


def _j_cm_core(j_eng):
    o = j_eng.options
    omega = 2.0 * np.pi * o.contacts.stabilization_freq
    return j_solver.make_constrained_period_integrator(
        j_eng._cdyn_cm, j_eng._build_tau_c(), j_eng._bound_gains,
        j_eng.tick_period / j_eng.n_substeps, 1, "rk4", j_eng.cset, None,
        omega * omega, 2.0 * omega, o.contacts.transition_eps, o.contacts.friction,
        o.contacts.torsion, o.stepper.pgs_regularization, o.stepper.pgs_iter_max,
        n_cmd=j_eng.robot.nmotors, imu_frames=j_eng._imu_frames,
        stage_warm_start=o.stepper.pgs_stage_warm_start, _return_core=True,
    )


def test_procedural_first_period_substep_matches_jax(envs):
    """One RK4 substep of the first controller period and its end outputs
    (accelerations, contact forces, IMU; on the constrained core the loop
    multipliers and active sets) at B=2."""
    env_id, (t_env, _, j_eng) = envs
    t_eng = _engine(t_env)
    t_inner = t_env.env if hasattr(t_env, "env") else t_env
    run = t_eng._get_period_run("rk4")
    if t_eng._cdyn_cm is not None:
        q, v, cmd, tail = loop_inputs(t_eng, t_inner.nominal_q.numpy(), 2, seed=21)
        cc = torch.cat([cmd, tail], dim=-1)
        got = run.plain(q, v, cc, n_substeps=1)
        core = _j_cm_core(j_eng)
        qc, vc, ccl = core["substep"](_comps(jnp.asarray(q.numpy())),
                                      _comps(jnp.asarray(v.numpy())),
                                      _comps(jnp.asarray(cc.numpy())))
        want = (qc, vc, core["final_outputs"](qc, vc, ccl))
        want = [_dense(w, q.shape[:-1]) for w in want]
    else:
        q, v, _ = perturbed_states(t_inner, 2, seed=22)
        cmd = torch.as_tensor(np.random.default_rng(23).normal(size=(2, t_env.robot.nmotors)))
        got = run.plain(q, v, cmd, n_substeps=1)
        j_run = j_eng._cdyn.make_period_integrator(
            j_eng._build_tau_c(), j_eng.tick_period / j_eng.n_substeps, 1, integrator="rk4",
            imu_frames=j_eng._imu_frames)
        want = j_run(jnp.asarray(q.numpy()), jnp.asarray(v.numpy()), jnp.asarray(cmd.numpy()))
    for g, w, what in zip(got, want, ("q", "v", "extras")):
        _close(g.numpy(), w, TOL, f"{env_id} {what}")
    nv = t_env.robot.nv
    assert float(got[2][..., nv:].abs().max()) > 1.0  # contact forces reach the outputs


@pytest.mark.slow
@pytest.mark.parametrize("env_id", ENVS)
def test_procedural_first_env_step_matches_jax(env_id):
    """The whole first env step, zero actions, B=1, from jiminy_tpu's reset
    state (its `reset(PRNGKey(0))`, given to the port's `reset_at`):
    jiminy_tpu's jitted fused step against the port's."""
    t_env, j_env, _ = _envs(env_id)
    j_st, _ = jax.jit(j_env.reset)(jax.random.PRNGKey(0))
    t_st, _ = t_env.reset_at(torch.as_tensor(np.asarray(j_st.sim.q)),
                             torch.as_tensor(np.asarray(j_st.sim.v)))
    action = np.zeros(t_env.action_size)
    t_out = t_env.step(t_st, torch.as_tensor(action))[0]
    j_out = jax.jit(j_env.step)(j_st, jnp.asarray(action))[0]
    for f in ("q", "v", "a"):
        _close(getattr(t_out.sim, f).numpy(), np.asarray(getattr(j_out.sim, f)), TOL, f)
