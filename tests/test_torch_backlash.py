"""Motor backlash in the port against jiminy_tpu on the CPU at float64.

A motor spec's `backlash` inserts a passive revolute joint of that play
(limits +-backlash/2) after its joint; the body moves to it and the motor
joint keeps the transmission (reference `robot.cc:582-630`). The backlash
joints are bound candidates beside the motor joints: penalty gains in
spring-damper bounds mode, PGS rows in constraint mode. Held on jiminy_tpu's
tests/test_backlash.py pendulum: the surgery and the bounds exactly, and a
run of controller periods through `Engine.step` (the constrained core)
within 1e-10 of jiminy_tpu's, across the dead band (the motor turns, the
load does not) and onto the stop (the load follows). Beside them the rigid
procedural ANYmal (`make("anymal", procedural=True)`, the look-alike whose
flexible variant `tests/test_torch_flexibility.py` holds): its robot and
core against jiminy_tpu's at 1e-12, a reset and a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_torch.engine.engine import Engine as TEngine
from jiminy_torch.engine.config import EngineOptions as TOptions
from jiminy_torch.engine.config import StepperOptions as TStepper
from jiminy_torch.engine.robot import Robot as TRobot
from jiminy_torch.envs import builders as t_builders
from jiminy_torch.envs import make as t_make
from jiminy_torch.models.model import ARRAY_FIELDS, META_FIELDS
from jiminy_torch.models.model import build_model as t_build_model
from jiminy_torch.ops import cdyn as t_cdyn
from jiminy_torch.testing import perturbed_states
from jiminy_tpu.engine import Engine as JEngine
from jiminy_tpu.engine import EngineOptions as JOptions
from jiminy_tpu.engine import Robot as JRobot
from jiminy_tpu.engine.config import StepperOptions as JStepper
from jiminy_tpu.envs import builders as j_builders
from jiminy_tpu.models import build_model as j_build_model
from jiminy_tpu.ops import cdyn as j_cdyn

PIVOT = [{"name": "pivot", "type": 1, "parent": -1, "axis": np.array([0.0, 1.0, 0.0]),
          "mass": 1.0, "com": np.array([0.0, 0.0, -0.5]), "inertia": np.zeros((3, 3))}]


def _pendulums(backlash):
    """(port, jiminy_tpu) pendulum with a motor of that backlash (jiminy_tpu's
    tests/test_backlash.py `_pendulum_with_backlash`)."""
    motors = [{"joint_name": "pivot", "backlash": backlash, "armature": 0.02}]
    return (TRobot.build(t_build_model("pend", PIVOT), motors=motors),
            JRobot.build(j_build_model("pend", PIVOT), motors=motors))


@pytest.mark.parametrize("backlash", [0.1, 0.2])
def test_backlash_surgery_matches_jax(backlash):
    tr, jr = _pendulums(backlash)
    tm, jm = tr.model, jr.model
    assert (tm.nq, tm.nv) == (2, 2) and tm.joint_names == tuple(jm.joint_names)
    assert tm.parents == tuple(jm.parents) and tm.joint_types == tuple(jm.joint_types)
    for f in ARRAY_FIELDS:
        np.testing.assert_allclose(getattr(tm, f), np.asarray(getattr(jm, f)), rtol=0, atol=1e-12,
                                   err_msg=f)
    j = tm.joint_index("pivot_backlash")
    assert tr.backlash_joint_indices == tuple(jr.backlash_joint_indices) == (j,)
    assert tm.position_limit_lower[tm.idx_q[j]] == -backlash / 2
    assert tm.mass[tm.joint_index("pivot")] == 0.0 and tm.mass[j] == 1.0
    assert tm.armature[tm.idx_v[tm.joint_index("pivot")]] > 0.0  # the rotor, folded
    assert tr.motors.joint_indices == tuple(jr.motors.joint_indices)
    assert tr.motors.v_indices == tuple(jr.motors.v_indices)
    # The theoretical model keeps the one joint; the maps carry the pivot
    assert tr.theoretical_model.njoints == 1
    np.testing.assert_array_equal(
        tr.extended_position_from_theoretical(torch.tensor([0.3], dtype=torch.float64)).numpy(),
        np.asarray(jr.extended_position_from_theoretical(jnp.asarray([0.3]))))


def test_backlash_joints_are_bound_candidates():
    """Penalty gains (spring-damper bounds mode) and PGS bound rows
    (constraint mode) on the backlash joint, as jiminy_tpu builds them."""
    tr, jr = _pendulums(0.1)
    pen_t = TEngine(tr, TOptions(joint_bounds_mode="penalty"), device="cpu", dtype=torch.float64)
    pen_j = JEngine(jr, JOptions(joint_bounds_mode="penalty"))
    assert pen_t._bound_gains.keys() == pen_j._bound_gains.keys() == {1}
    for vi, gains in pen_t._bound_gains.items():
        np.testing.assert_allclose(gains, np.asarray(pen_j._bound_gains[vi], np.float64),
                                   rtol=1e-12, atol=0)
    cm_t = TEngine(tr, TOptions(), device="cpu", dtype=torch.float64)
    cm_j = JEngine(jr, JOptions())
    assert cm_t.cset.bound_joint_indices == tuple(cm_j.cset.bound_joint_indices) == (1,)
    assert cm_t._cdyn_cm is not None  # the backlash joint is revolute: the constrained core


def _engines():
    tr, jr = _pendulums(0.2)
    t_eng = TEngine(tr, TOptions(stepper=TStepper(dt_max=5e-4)), device="cpu",
                    dtype=torch.float64)
    j_eng = JEngine(jr, JOptions(stepper=JStepper(dt_max=5e-4)))
    return t_eng, j_eng


def test_backlash_dead_band_matches_jax():
    """A constant motor torque from rest through `Engine.step` (the
    constrained core), against jiminy_tpu's within 1e-10: after 40 periods
    the motor has turned inside the play and the load has not (the dead
    band); after 100 the backlash angle rides its negative stop (its PGS
    row active) and the torque turns the load through it."""
    t_eng, j_eng = _engines()
    model = t_eng.robot.model
    jb, jm = (model.idx_q[model.joint_index(n)] for n in ("pivot_backlash", "pivot"))
    st = t_eng.reset(torch.zeros(2, dtype=torch.float64))
    js = j_eng.reset(jnp.zeros(2))
    step = jax.jit(j_eng.step)
    cmd = torch.tensor([1.0], dtype=torch.float64)
    for n in range(1, 101):
        st = t_eng.step(st, cmd)
        js = step(js, jnp.asarray([1.0]))
        if n not in (40, 100):
            continue
        for f in ("q", "v", "a", "lam"):
            np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(js, f)),
                                       rtol=0, atol=1e-10, err_msg=f"{f} after {n} periods")
        q_b, q_m = float(st.q[jb]), float(st.q[jm])
        if n == 40:
            assert q_m > 0.03 and abs(q_m + q_b) < 1e-3 and not bool(st.bound_active.any())
    assert -0.13 < q_b < -0.07 and bool(st.bound_active.any())
    assert q_m + q_b > 5e-3


def test_procedural_anymal_matches_jax():
    """`make("anymal", procedural=True)`, the rigid look-alike: its robot and
    its core (the fused kernels' plain version) against jiminy_tpu's, and a
    reset and a step on the fused path."""
    tr, jr = t_builders.build_anymal(False), j_builders.build_anymal(False)
    for f in META_FIELDS:
        assert tuple(np.atleast_1d(getattr(tr.model, f))) == tuple(
            np.atleast_1d(getattr(jr.model, f))), f
    for f in ARRAY_FIELDS:
        np.testing.assert_allclose(getattr(tr.model, f), np.asarray(getattr(jr.model, f)),
                                   rtol=0, atol=1e-12, err_msg=f)
    env = t_make("anymal", procedural=True, device="cpu", dtype=torch.float64)
    eng = env.engine
    assert eng.supports_fused_rollout and not eng._stagewise and env.robot.nq == 19
    q, v, tau = (x.numpy() for x in perturbed_states(env, 8, seed=6))
    jd = j_cdyn.ComponentDynamics(jr.model, (0.0, 0.0, -9.81), contact_opts=eng.options.contacts,
                                  contact_frames=jr.contact_frame_indices,
                                  bound_gains=eng._bound_gains)
    a = eng._cdyn.accel(*(torch.as_tensor(x) for x in (q, v, tau)))
    assert t_cdyn.supports_model(tr.model)
    with jax.disable_jit():
        ref = np.asarray(jd.accel(jnp.asarray(q), jnp.asarray(v), jnp.asarray(tau)))
    np.testing.assert_allclose(a.numpy(), ref, rtol=0, atol=1e-12 * max(np.abs(ref).max(), 1.0))
    st, _ = env.reset(batch_size=2)
    st, _, reward, *_ = env.step(st, torch.zeros(12, dtype=torch.float64))
    assert bool(torch.isfinite(st.sim.q).all()) and bool(torch.isfinite(reward).all())
