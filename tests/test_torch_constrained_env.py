"""The port's constrained slice end to end against jiminy_tpu on the CPU at
float64: `anymal-pid` in constraint contact mode (ground contacts and joint
bounds through the PGS solver, as `bench.py` builds it with
`BENCH_CONTACT=constraint`), reset plus one env step, on the fused rollout
path and on the per-period path; and full multi-tick env steps of the small
bounded arm of tests/test_fused_rollout.py with its joint bounds through the
solver.

Cut to size: the ANYmal env step is one controller tick of one RK4 substep
(controller and sensor periods equal to `dt_max` = 1 ms, `step_dt` = 1 ms),
given to both packages as explicit `options`; the `WalkerEnv` defaults would
run 8 ticks of 5 substeps, 168 constrained solves, each a few seconds in
eager jiminy_tpu. The base starts 2 cm lower and the left front hip past its
upper bound (which lifts that foot), so three contacts and a bound row are
active from the first solve. jiminy_tpu runs eagerly under `jax.disable_jit()` (compiling
its constrained ANYmal graph takes minutes); the arm compiles in seconds and
runs jitted.

Tolerance: 1e-12 absolute plus 1e-12 relative, as for the spring-damper
slice (the Gauss-Seidel row dot is a reduction in the port and a sequential
sum in jiminy_tpu; XLA may reassociate inside the arm's fusions).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_torch.engine import config as t_config
from jiminy_torch.engine.robot import Robot as TRobot
from jiminy_torch.envs import make as t_make
from jiminy_torch.gym.base import BaseEnv as TBaseEnv
from jiminy_torch.gym.blocks import PDController as TPD
from jiminy_torch.gym.pipeline import ControlledEnv as TControlled
from jiminy_torch.models.model import build_model as t_build_model
from jiminy_torch.testing import constraint_mode_options
from jiminy_tpu.engine import config as j_config
from jiminy_tpu.engine.robot import Robot as JRobot
from jiminy_tpu.envs import make as j_make
from jiminy_tpu.gym.base import BaseEnv as JBaseEnv
from jiminy_tpu.gym.blocks import PDController as JPD
from jiminy_tpu.gym.pipeline import ControlledEnv as JControlled
from jiminy_tpu.models import build_model as j_build_model
from test_torch_cdyn import _ARM_HW, _ARM_JOINTS, _PD

TOL = dict(atol=1e-12, rtol=1e-12)
DT = 1e-3
ACTION = np.random.default_rng(4).normal(size=12) * 10.0


def _lowered(nominal_q):
    q = np.array(nominal_q, np.float64)
    q[2] -= 0.02  # the feet about 2 cm into the ground
    q[7] = 0.55  # LF_HAA past its upper bound, 0.49 (the LF foot lifts)
    return q


def _port_env(fused: bool):
    base = t_make("anymal-pid", device="cpu", dtype=torch.float64).engine.options
    opts = constraint_mode_options(base).replace(controller_update_period=DT,
                                                 sensor_update_period=DT)
    env = t_make("anymal-pid", device="cpu", dtype=torch.float64, options=opts, step_dt=DT)
    env.use_fused_rollout = fused
    env.env.nominal_q = torch.as_tensor(_lowered(env.env.nominal_q))
    return env


@pytest.fixture(scope="module")
def reference():
    """jiminy_tpu's reset and one env step, eager."""
    opts = j_make("anymal-pid").env.engine.options
    opts = opts.replace(
        contacts=dataclasses.replace(opts.contacts, model=j_config.ContactModel.CONSTRAINT),
        joint_bounds_mode="constraint", use_fast_dynamics="always",
        controller_update_period=DT, sensor_update_period=DT,
    )
    env = j_make("anymal-pid", options=opts, step_dt=DT)
    env.env.nominal_q = jnp.asarray(_lowered(env.env.nominal_q))
    with jax.disable_jit():
        st0, _ = env.reset(jax.random.PRNGKey(0))
        st1, _, reward, terminated, _, _ = env.step(st0, jnp.asarray(ACTION))
    return st0, st1, reward, terminated


def _port_run(fused: bool):
    env = _port_env(fused)
    st0, _ = env.reset()
    st1, _, reward, terminated, _, _ = env.step(st0, torch.as_tensor(ACTION))
    return st0, st1, reward, terminated


def _compare(a, b):
    np.testing.assert_allclose(np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a),
                               np.asarray(b), **TOL)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_period"])
def test_constrained_anymal_step_matches_jax(reference, fused):
    j0, j1, j_reward, j_term = reference
    t0, t1, t_reward, t_term = _port_run(fused)
    # The reset: cold-start solve, contact forces from the multipliers
    for key in ("q", "a", "lam", "contact_forces", "contact_active", "bound_active"):
        _compare(getattr(t0.sim, key), getattr(j0.sim, key))
    assert int(t0.sim.contact_active.sum()) == 3 and bool(t0.sim.bound_active[0])
    # The step
    for key in ("t", "q", "v", "a", "command", "u_motor", "lam", "contact_forces",
                "contact_active", "bound_active"):
        _compare(getattr(t1.sim, key), getattr(j1.sim, key))
    for name, meas in t1.sim.measurements.items():
        _compare(meas, j1.sim.measurements[name])
    _compare(t1.blocks["pd_controller"], j1.blocks["pd_controller"])
    _compare(t_reward, j_reward)
    assert bool(t_term) == bool(j_term)
    assert float(t1.sim.contact_forces[:, 2].sum()) > 100.0  # the feet carry the robot


def test_constrained_anymal_paths_agree():
    """The fused rollout and the per-period path run the same function."""
    fused, per_period = _port_run(True), _port_run(False)
    for key in ("q", "v", "a", "lam", "contact_forces", "command"):
        _compare(getattr(fused[1].sim, key), getattr(per_period[1].sim, key))


# --------------------------------------------------------------------------- #
# Full env steps: the bounded arm, joint bounds through the solver
# --------------------------------------------------------------------------- #


def _arm_options(cfg):
    return cfg.EngineOptions(
        stepper=cfg.StepperOptions(integrator=cfg.IntegratorType.RUNGE_KUTTA_4, dt_max=2e-3),
        controller_update_period=0.01,
        sensor_update_period=0.01,
        joint_bounds_mode="constraint",
    )


def _arm_envs(fused: bool):
    j_base = JBaseEnv(JRobot.build(j_build_model("arm2", _ARM_JOINTS, []), **_ARM_HW),
                      _arm_options(j_config).replace(use_fast_dynamics="always"),
                      step_dt=0.04, horizon=100)
    t_base = TBaseEnv(TRobot.build(t_build_model("arm2", _ARM_JOINTS, []), **_ARM_HW),
                      _arm_options(t_config), step_dt=0.04, horizon=100, device="cpu",
                      dtype=torch.float64)
    q0 = np.array([0.3, -0.5])
    j_base._sample_state = lambda key: (jnp.asarray(q0), jnp.zeros(2))
    t_base._sample_state = lambda batch: (
        torch.as_tensor(q0).expand(batch + (2,)), torch.zeros(batch + (2,), dtype=torch.float64)
    )
    return (
        TControlled(t_base, TPD(**_PD).setup(t_base), use_fused_rollout=fused),
        JControlled(j_base, JPD(**_PD).setup(j_base), use_fused_rollout=fused),
    )


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_period"])
def test_constrained_arm_env_steps_match_jax(fused):
    """Seven env steps of four controller ticks of five RK4 substeps, driven
    into the shoulder bound: the PGS bound row engages at the sixth."""
    t_env, j_env = _arm_envs(fused)
    assert t_env.env.engine.cset.total_rows == 2 and t_env.env.engine._cdyn_cm is not None
    st_t, _ = t_env.reset()
    st_j, _ = j_env.reset(jax.random.PRNGKey(5))
    step_j = jax.jit(j_env.step)
    action = np.array([500.0, 0.0])
    engaged = False
    for _ in range(7):
        st_t, *_ = t_env.step(st_t, torch.as_tensor(action))
        st_j, *_ = step_j(st_j, jnp.asarray(action))
        engaged |= bool(st_t.sim.bound_active.any())
    for key in ("q", "v", "a", "lam", "bound_active", "command"):
        _compare(getattr(st_t.sim, key), getattr(st_j.sim, key))
    _compare(st_t.blocks["pd_controller"], st_j.blocks["pd_controller"])
    assert engaged and float(st_t.sim.q[0]) < 2.05


def test_constrained_anymal_full_step_physics():
    """One uncut env step (8 ticks of 5 substeps, 168 PGS solves) of the plain
    path from the lowered pose: the solver's boxes and cones hold and the
    feet push the robot up."""
    base = t_make("anymal-pid", device="cpu", dtype=torch.float64).engine.options
    env = t_make("anymal-pid", device="cpu", dtype=torch.float64,
                 options=constraint_mode_options(base))
    env.env.nominal_q = torch.as_tensor(_lowered(env.env.nominal_q))
    st, _ = env.reset(batch_size=2)
    st, _, _, terminated, _, _ = env.step(st, torch.as_tensor(ACTION))
    sim = st.sim
    nb = env.engine.cset.n_bounds
    lam_n = sim.lam[:, nb + 2::4]
    lam_t = torch.hypot(sim.lam[:, nb::4], sim.lam[:, nb + 1::4])
    assert torch.isfinite(sim.q).all() and not bool(terminated.any())
    assert bool((sim.lam[:, :nb] >= 0).all()) and bool((lam_n >= 0).all())
    assert bool((lam_t <= env.engine.options.contacts.friction * lam_n * (1 + 1e-12)).all())
    assert float(lam_n.sum(-1).min()) > 100.0
    assert bool((sim.v[:, 2] > 0).all())  # pushed out of the 2 cm penetration
