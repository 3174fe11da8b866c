"""Forests through the port's component core: the multi-robot engine's
merged model with several roots (`engine/merge.py`), no coupling.

- A small forest (a free body with a ground contact beside the acrobot)
  through the port's component core (its plain version here) against
  single engines and against jiminy_tpu's MultiRobotEngine (its generic
  path: compiling its fused forest period takes over ten minutes on the
  CPU; its core takes the forest too) at 1e-12.
- The ANYmal + acrobot forest of `chip_smoke.py`, in both contact modes,
  against single engines at 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_torch.engine.engine import Engine as TEngine
from jiminy_torch.engine.multi import MultiRobotEngine as TMulti
from jiminy_torch.envs import builders as t_builders
from jiminy_torch.envs import make as t_make
from jiminy_torch.testing import constraint_mode_options, forest_robots
from jiminy_tpu.engine.multi import MultiRobotEngine as JMulti
from jiminy_tpu.envs import builders as j_builders
from test_torch_multi_robot import _free_body, _options, t64


# --------------------------------------------------------------------------- #
# Forests through the component core
# --------------------------------------------------------------------------- #


def test_small_forest_through_the_core_matches_singles_and_jax():
    """A free body with a ground contact beside the acrobot, gravity on: the
    merged model has two roots (FREE at joint 0, as jiminy_tpu's core asks),
    steps through the port's component core (its plain version on the CPU)
    and jiminy_tpu's fused core, and matches single engines."""
    def robots(pkg):
        builders = t_builders if pkg == "t" else j_builders
        return {"ball": _free_body(pkg, "ball", contact=True), "acrobot": builders.build_acrobot()}

    t_opts = _options("t", gravity=(0.0, 0.0, -9.81), controller_update_period=2e-3,
                      joint_bounds_mode="none")
    j_opts = _options("j", gravity=(0.0, 0.0, -9.81), controller_update_period=2e-3,
                      joint_bounds_mode="none")
    t_multi = TMulti(robots("t"), t_opts, device="cpu", dtype=torch.float64)
    j_multi = JMulti(robots("j"), j_opts)
    assert t_multi.engine._cdyn is not None and t_multi.engine._use_core()
    fast = JMulti(robots("j"), j_opts.replace(use_fast_dynamics="always"))
    assert fast.engine._cdyn is not None  # jiminy_tpu's core takes the forest too
    assert t_multi.merged_robot.model.parents == (-1, -1, 1)
    q_ball = np.array([[0.0, 0.0, 0.09, 0.0, 0.0, 0.0, 1.0], [0.1, 0.0, 0.05, 0.0, 0.0, 0.0, 1.0]])
    q_ac = np.array([[0.3, -0.2], [0.1, 0.5]])
    cmd = {"ball": np.zeros((2, 0)), "acrobot": np.array([[1.0], [-0.5]])}
    states = t_multi.reset({"ball": t64(q_ball), "acrobot": t64(q_ac)})
    assert float(states["ball"].contact_forces.abs().max()) > 1.0  # the ball's point touches
    singles = {n: TEngine(r, t_opts, device="cpu", dtype=torch.float64)
               for n, r in robots("t").items()}
    sts = {"ball": singles["ball"].reset(t64(q_ball)), "acrobot": singles["acrobot"].reset(t64(q_ac))}
    # jiminy_tpu's generic path on the CPU (compiling its fused forest period
    # takes over ten minutes here): the same dynamics in array form
    j_states = jax.jit(jax.vmap(lambda a, b: j_multi.reset({"ball": a, "acrobot": b})))(
        jnp.asarray(q_ball), jnp.asarray(q_ac))
    j_step = jax.jit(jax.vmap(j_multi.step))
    for _ in range(3):
        states = t_multi.step(states, {n: t64(c) for n, c in cmd.items()})
        sts = {n: singles[n].step(sts[n], t64(cmd[n])) for n in sts}
        j_states = j_step(j_states, {n: jnp.asarray(c) for n, c in cmd.items()})
    for n in ("ball", "acrobot"):
        for f in ("q", "v", "a"):
            got = getattr(states[n], f).numpy()
            np.testing.assert_allclose(got, getattr(sts[n], f).numpy(), atol=1e-12, rtol=0)
            np.testing.assert_allclose(got, np.asarray(getattr(j_states[n], f)), atol=1e-12,
                                       rtol=0, err_msg=f"{n} {f}")


@pytest.mark.parametrize("constraint", [False, True], ids=["spring", "constraint"])
def test_anymal_acrobot_forest_matches_single_engines(constraint):
    """The forest `chip_smoke.py` sends through the kernels: the ANYmal
    (FREE root, joint 0) and the acrobot, `anymal-pid`'s options, in the
    spring-damper core (cdyn_period on the card) or the constrained one
    (cdyn_period_cm), one period against each robot's own engine."""
    base = t_make("anymal-pid", device="cpu", dtype=torch.float64)
    opts = constraint_mode_options(base.engine.options) if constraint else base.engine.options
    robots = forest_robots()
    multi = TMulti(robots, opts, device="cpu", dtype=torch.float64)
    core = multi.engine._cdyn_cm if constraint else multi.engine._cdyn
    assert core is not None
    q_an = base.env.nominal_q.expand(2, -1)
    q_ac = t64([[0.3, -0.2], [2.0, 0.5]])
    cmd = {"anymal": torch.full((2, 12), 0.2, dtype=torch.float64), "acrobot": t64([[1.0], [-2.0]])}
    states = multi.step(multi.reset({"anymal": q_an, "acrobot": q_ac}), cmd)
    for name, q0 in (("anymal", q_an), ("acrobot", q_ac)):
        single = TEngine(robots[name], opts, device="cpu", dtype=torch.float64)
        st = single.step(single.reset(q0), cmd[name])
        for f in ("q", "v", "a"):
            np.testing.assert_allclose(getattr(states[name], f).numpy(), getattr(st, f).numpy(),
                                       atol=1e-12, rtol=0, err_msg=f"{name} {f}")
