"""The toy envs (cartpole, acrobot, pendulum) of the port against jiminy_tpu
on the CPU at float64.

- Their golden initial states (`tests/goldens_torch/toy_initial_states.json`)
  are jiminy_tpu's, bit for bit, and the port's reset from them gives
  jiminy_tpu's reset state bit for bit.
- Which path each takes: the cartpole and the acrobot (`continuous` joints)
  the generic path, the pendulum the constrained core (`cdyn_rollout_cm`,
  `cdyn_period_cm` on the card) unless an external force or
  `use_fast_dynamics=False` sends it to the generic path.
- One engine period of each toy (the pendulum also on the generic path)
  against jiminy_tpu's jitted engine period, from states drawn with numpy,
  at 1e-10; and one with external forces (a profile force, an impulse and a
  state force) registered in both engines.
- The first rows of `tests/goldens/{cartpole,acrobot,pendulum}.csv`
  through `make(...)`, from the golden initial states with the actions of
  `tests/golden_configs.py::_actions_sin`, on the default and the
  per-period paths, at 1e-10 (the slow tier: every row). Measured at
  float64 on a CPU, over every row: at most 5.6e-16 (cartpole), 1.9e-15
  (acrobot) and 6.2e-15 (pendulum) from the goldens, so no toy amplifies
  rounding here and no one-ulp witness is needed. On the generic
  path (cartpole, acrobot) both paths are one path: the engine has no fused
  rollout there, so the env steps period by period either way.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_configs import CONFIGS, read_golden
from jiminy_torch.envs import make as t_make
from jiminy_tpu.envs import make as j_make

ATOL = 1e-10
HERE = os.path.dirname(os.path.abspath(__file__))
STATES = os.path.join(HERE, "goldens_torch", "toy_initial_states.json")
TOYS = ("cartpole", "acrobot", "pendulum")


def _states():
    with open(STATES) as f:
        raw = json.load(f)
    return {k: (np.array([float.fromhex(x) for x in r["q0"]]),
                np.array([float.fromhex(x) for x in r["v0"]]), r) for k, r in raw.items()}


def test_initial_states_file_is_jiminy_tpu_reset():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "toy_states_generate", os.path.join(HERE, "goldens_torch", "generate.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    with open(STATES) as f:
        assert json.load(f) == gen.initial_states()
    for env_id, (q0, v0, raw) in _states().items():
        assert raw["n_rows"] == len(read_golden(env_id))
        j_env = j_make(env_id)
        jst, _ = j_env.reset(jax.random.PRNGKey(raw["seed"]))
        t_env = t_make(env_id, device="cpu", dtype=torch.float64)
        tst, _ = t_env.reset_at(torch.as_tensor(q0), torch.as_tensor(v0))
        np.testing.assert_array_equal(tst.sim.q.numpy(), np.asarray(jst.sim.q))
        np.testing.assert_array_equal(tst.sim.v.numpy(), np.asarray(jst.sim.v))
        np.testing.assert_allclose(tst.sim.a.numpy(), np.asarray(jst.sim.a), atol=1e-12, rtol=0)
    assert set(CONFIGS["acrobot_pendulum"][0]) | {CONFIGS["cartpole"][0]} == set(TOYS)


def test_toys_take_jiminy_tpus_paths():
    for env_id in TOYS:
        env = t_make(env_id, device="cpu", dtype=torch.float64)
        eng = env.engine
        if env_id == "pendulum":
            assert eng._cdyn_cm is not None and eng.supports_fused_rollout
            assert eng.cset.n_bounds == 1 and eng.cset.n_contacts == 0
            generic = t_make(env_id, device="cpu", dtype=torch.float64,
                             options=eng.options.replace(use_fast_dynamics=False)).engine
            assert generic._cdyn_cm is None and not generic.supports_fused_rollout
            eng.register_impulse_force("PendulumMass", 0.0, 1.0, [0.0] * 6)
            assert not eng.supports_fused_rollout and not eng._use_core()
            eng.remove_forces()
            assert eng.supports_fused_rollout
        else:
            assert eng._cdyn is None and eng._cdyn_cm is None
            assert not eng.supports_fused_rollout
        assert env.action_size == 1


def _period_inputs(env, seed, batch=3):
    """Batched (q, v, command) drawn with numpy: angles up to 1 rad, the
    cartpole's slider also past its +-10 m bound in one env."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-1.0, 1.0, size=(batch, len(env.layout.joints)))
    if env.robot.model.joint_names[0] == "slider_to_cart":
        th[0, 0] = 10.02
    q = env.layout.q_of(torch.as_tensor(th)).numpy()
    v = rng.normal(size=(batch, env.robot.nv))
    cmd = rng.normal(size=(batch, 1)) * 5.0
    return q, v, cmd


def _j_period(j_eng, q, v, cmd):
    st = jax.vmap(lambda q_, v_: j_eng.reset(q_, v_))(jnp.asarray(q), jnp.asarray(v))
    return jax.jit(jax.vmap(j_eng.step))(st, jnp.asarray(cmd))


def _t_period(t_eng, q, v, cmd):
    st = t_eng.reset(torch.as_tensor(q), torch.as_tensor(v))
    return st, t_eng.step(st, torch.as_tensor(cmd))


def _assert_periods(t_st, j_st, reset_t=None, reset_j=None):
    for f in ("q", "v", "a", "u_motor"):
        np.testing.assert_allclose(getattr(t_st, f).numpy(), np.asarray(getattr(j_st, f)),
                                   atol=ATOL, rtol=0, err_msg=f)
    for f in ("lam", "bound_active"):
        if getattr(t_st, f) is not None and getattr(t_st, f).numel():
            np.testing.assert_allclose(getattr(t_st, f).numpy(), np.asarray(getattr(j_st, f)),
                                       atol=ATOL, rtol=0, err_msg=f)


@pytest.mark.parametrize("env_id,generic", [("cartpole", True), ("acrobot", True),
                                            ("pendulum", False), ("pendulum", True)])
def test_toy_engine_period_matches_jax(env_id, generic):
    t_env = t_make(env_id, device="cpu", dtype=torch.float64)
    if generic and env_id == "pendulum":
        t_env = t_make(env_id, device="cpu", dtype=torch.float64,
                       options=t_env.engine.options.replace(use_fast_dynamics=False))
    j_eng = j_make(env_id).engine
    q, v, cmd = _period_inputs(t_env, seed=len(env_id))
    st0, t_st = _t_period(t_env.engine, q, v, cmd)
    j_st = _j_period(j_eng, q, v, cmd)
    _assert_periods(t_st, j_st)
    if env_id == "cartpole":  # the slider's bound row acted in env 0
        assert bool(t_st.bound_active[0, 0]) and float(t_st.lam[0, 0]) > 0.0


def test_external_forces_match_jax():
    """A profile force at the acrobot's tip, an impulse on its second arm and
    a state force (a torsion spring on the first joint) in both engines."""
    t_eng = t_make("acrobot", device="cpu", dtype=torch.float64).engine
    j_eng = j_make("acrobot").engine
    t_eng.register_profile_force(
        "Tip", lambda t: torch.stack([0.0 * t, 0.3 + 0.0 * t, 0.0 * t,
                                      2.0 * torch.sin(50.0 * t), 0.0 * t, 1.0 + 0.0 * t], dim=-1))
    j_eng.register_profile_force(
        "Tip", lambda t: jnp.stack([0.0 * t, 0.3 + 0.0 * t, 0.0 * t,
                                    2.0 * jnp.sin(50.0 * t), 0.0 * t, 1.0 + 0.0 * t], axis=-1))
    wrench = [0.1, 0.0, 0.2, 3.0, -1.0, 0.5]
    t_eng.register_impulse_force("SecondArm", 0.0002, 0.0005, wrench)
    j_eng.register_impulse_force("SecondArm", 0.0002, 0.0005, wrench)

    def t_spring(t, q, v, kin):
        f = torch.zeros(q.shape[:-1] + (2, 6), dtype=q.dtype)
        f[..., 0, 1] = -3.0 * torch.atan2(q[..., 1], q[..., 0])
        return f

    def j_spring(t, q, v, kin):
        f = jnp.zeros(q.shape[:-1] + (2, 6), q.dtype)
        return f.at[..., 0, 1].set(-3.0 * jnp.arctan2(q[..., 1], q[..., 0]))

    t_eng.register_state_force(t_spring)
    j_eng.register_state_force(j_spring)
    q, v, cmd = _period_inputs(t_make("acrobot", device="cpu", dtype=torch.float64), seed=9)
    _, t_st = _t_period(t_eng, q, v, cmd)
    j_st = _j_period(j_eng, q, v, cmd)
    _assert_periods(t_st, j_st)
    # The forces act: without them the period ends elsewhere
    t_eng.remove_forces()
    _, bare = _t_period(t_eng, q, v, cmd)
    assert float((bare.v - t_st.v).abs().max()) > 1e-4


def _golden_rows(env_id, fused: bool, n_rows: int):
    q0, v0, _ = _states()[env_id]
    env = t_make(env_id, device="cpu", dtype=torch.float64)
    env.use_fused_rollout = fused
    st, _ = env.reset_at(torch.as_tensor(q0), torch.as_tensor(v0))
    actions = CONFIGS["cartpole" if env_id == "cartpole" else "acrobot_pendulum"][2](env, n_rows)
    rows = []
    for k in range(n_rows):
        st, _, reward, _, _, _ = env.step(st, torch.as_tensor(actions[k]))
        sim = st.sim
        rows.append(np.concatenate([[float(sim.t)], sim.q.numpy(), sim.v.numpy(),
                                    [float(reward)], sim.contact_forces.numpy().ravel()]))
    return np.stack(rows)


@pytest.mark.parametrize("fused", [True, False], ids=["default", "per_period"])
@pytest.mark.parametrize("env_id", TOYS)
def test_toy_first_golden_rows(env_id, fused):
    golden = read_golden(env_id)
    np.testing.assert_allclose(_golden_rows(env_id, fused, 2), golden[:2], atol=ATOL, rtol=0)


@pytest.mark.slow
@pytest.mark.parametrize("fused", [True, False], ids=["default", "per_period"])
@pytest.mark.parametrize("env_id", TOYS)
def test_toy_all_golden_rows(env_id, fused):
    golden = read_golden(env_id)
    np.testing.assert_allclose(_golden_rows(env_id, fused, len(golden)), golden, atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("env_id", TOYS)
def test_procedural_toys_match_jax(env_id):
    """`procedural=True`: the parametric builders' models, motors and sensors
    are jiminy_tpu's."""
    from jiminy_torch.engine.hardware import MOTOR_ARRAY_FIELDS
    from jiminy_torch.models.model import ARRAY_FIELDS, META_FIELDS

    t_robot = t_make(env_id, device="cpu", dtype=torch.float64, procedural=True).robot
    j_robot = j_make(env_id, procedural=True).robot
    for f in META_FIELDS:
        assert tuple(np.atleast_1d(getattr(t_robot.model, f))) == tuple(
            np.atleast_1d(getattr(j_robot.model, f))), f
    for f in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(t_robot.model, f),
                                      np.asarray(getattr(j_robot.model, f)), err_msg=f)
    for f in MOTOR_ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(t_robot.motors, f),
                                      np.asarray(getattr(j_robot.motors, f)), err_msg=f)
    assert [n for n, _ in t_robot.sensors.groups()] == [n for n, _ in j_robot.sensors.groups()]


def test_encoders_and_pd_read_unbounded_joints():
    """Encoders on `continuous` joints read the angle atan2(sin, cos), as
    jiminy_tpu's; the PD block's in-kernel form reads it the same way and
    its kernel packing refuses it (such models run the generic path)."""
    from jiminy_torch.engine.robot import Robot as TRobot
    from jiminy_torch.ops import cdyn
    from jiminy_tpu.engine.robot import Robot as JRobot

    sensors = {"encoder": [{"joint_name": "FirstArmJoint"}, {"joint_name": "SecondArmJoint"}]}
    t_robot = TRobot.build(t_make("acrobot", device="cpu").robot.model, sensors=sensors)
    j_robot = JRobot.build(j_make("acrobot").robot.model, sensors=sensors)
    t_enc, j_enc = t_robot.sensors.encoder, dict(j_robot.sensors.groups())["encoder"]
    env = t_make("acrobot", device="cpu", dtype=torch.float64)
    q, v, _ = _period_inputs(env, seed=3, batch=5)
    q[:, :2] *= -1.0  # angles past +-pi/2
    got = t_enc.compute_raw(t_robot.model, None, torch.as_tensor(q), torch.as_tensor(v), None,
                            None, None)
    want = j_enc.compute_raw(j_robot.model, None, jnp.asarray(q), jnp.asarray(v), None, None, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-15, rtol=0)
    pd = cdyn.PDComponents(dt=1e-3, kp=(10.0, 10.0), kd=(0.1, 0.1), smin=((-9.0,) * 2,) * 3,
                           smax=((9.0,) * 2,) * 3, eff=(5.0, 5.0), red=(1.0, 1.0),
                           q_indices=t_enc.q_indices, v_indices=t_enc.v_indices,
                           joint_side=(True, True), unbounded=(True, True))
    qc = [torch.as_tensor(q[:, i]) for i in range(q.shape[1])]
    vc = [torch.as_tensor(v[:, i]) for i in range(v.shape[1])]
    zero = [torch.zeros(5, dtype=torch.float64)] * 6
    cmd, _ = pd(qc, vc, zero, [torch.zeros(5, dtype=torch.float64)] * 2)
    want_u = torch.clamp(10.0 * ((0.0 - got[..., 0]) + 0.1 * (0.0 - got[..., 1])), -5.0, 5.0)
    np.testing.assert_allclose(torch.stack(cmd, -1).numpy(), want_u.numpy(), atol=1e-12, rtol=0)
    with pytest.raises(NotImplementedError, match="generic path"):
        pd.pack("cpu", torch.float64)


def test_generic_dopri_period_matches_jax():
    """Adaptive DOPRI on the generic path (no PGS row: the acrobot), the
    masked lock-step loop on `dynamics_full`, against jiminy_tpu's jitted
    DOPRI period."""
    from jiminy_torch.testing import dopri_options
    from jiminy_tpu.engine import config as j_config

    base = t_make("acrobot", device="cpu", dtype=torch.float64).engine.options
    t_eng = t_make("acrobot", device="cpu", dtype=torch.float64,
                   options=dopri_options(base)).engine
    j_env = j_make("acrobot")
    j_opts = j_env.engine.options
    j_opts = j_opts.replace(stepper=dataclasses.replace(
        j_opts.stepper, integrator=j_config.IntegratorType.RUNGE_KUTTA_DOPRI))
    j_eng = type(j_env.engine)(j_env.robot, j_opts)
    assert t_eng._cdyn is None and not t_eng.supports_fused_rollout
    q, v, cmd = _period_inputs(t_make("acrobot", device="cpu", dtype=torch.float64), seed=4)
    _, t_st = _t_period(t_eng, q, v, cmd)
    j_st = _j_period(j_eng, q, v, cmd)
    _assert_periods(t_st, j_st)
    np.testing.assert_array_equal(t_st.stepper.iterations.numpy(),
                                  np.asarray(j_st.stepper.iterations))
    np.testing.assert_array_equal(t_st.stepper.iter_failed.numpy(),
                                  np.asarray(j_st.stepper.iter_failed))
