"""The port's `atlas-reduced-pid` against jiminy_tpu tick by tick, on the CPU
at float64: the first env step of tests/goldens/atlas-reduced-pid.csv (zero
actions, one env), its sixteen controller periods each started from
jiminy_tpu's own state and PD command state, through the PD block and one
engine period (5 RK4 substeps of spring-damper contact and penalty bounds)
of each package.

A whole env step cannot be held this tightly: after the feet touch down the
standing Atlas amplifies any difference tenfold a tick (tests/test_torch_atlas.py
holds the golden rows to the reach of rounding). Started from the same state,
one period of each package agrees to rounding: held at 1e-12 relative plus
1e-12 absolute (contact forces reach 2e2 N; XLA reassociates inside its
fusions), but for what the contact springs set: the contact forces, the
force sensors, and the accelerations of the period's last evaluation (which
jiminy_tpu computes on the CPU with its generic ABA and contact pass) and
the IMU that reads them. A
contact's force moves by its damping (843 N s/m) times its velocity, held at
1e-12, so these are held at 1e-8 absolute, the six points of a foot summed
with a margin.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from jiminy_torch.envs import make as t_make
from jiminy_tpu.envs import make as j_make

N_TICKS = 16
TOL = dict(atol=1e-12, rtol=1e-12)
TOL_CONTACT = dict(atol=1e-8, rtol=0.0)


def _from_jax(j_sim, like):
    """The port's SimState holding jiminy_tpu's values."""

    def conv(x, ref):
        return torch.as_tensor(np.array(x)).to(ref.dtype)

    kw = {}
    for f in dataclasses.fields(like):
        ref = getattr(like, f.name)
        if ref is None:
            continue
        val = getattr(j_sim, f.name)
        if f.name == "measurements":
            kw[f.name] = {k: conv(val[k], ref[k]) for k in ref}
        elif f.name == "stepper":
            kw[f.name] = ref.replace(**{g.name: conv(getattr(val, g.name), getattr(ref, g.name))
                                        for g in dataclasses.fields(ref)})
        else:
            kw[f.name] = conv(val, ref)
    return like.replace(**kw)


def _close(got, ref, what, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), err_msg=what, **tol)


def test_atlas_reduced_pid_ticks_match_jax():
    t_env, j_env = t_make("atlas-reduced-pid", device="cpu", dtype=torch.float64), j_make(
        "atlas-reduced-pid")
    t_st, _ = t_env.reset()
    j_st, _ = j_env.reset(jax.random.PRNGKey(4))
    name = t_env.block.name
    t_act = torch.zeros(t_env.action_size, dtype=torch.float64)
    j_act = jnp.zeros(t_env.action_size)
    j_step = jax.jit(j_env.env.engine.step)
    j_ctrl = jax.jit(
        lambda sim, bs: j_env.block.compute(j_act, j_env.env.observe(j_st.replace(sim=sim)), bs)
    )
    j_sim, j_bs = j_st.sim, j_st.blocks[name]
    touched = []
    for tick in range(N_TICKS):
        t_sim = _from_jax(j_sim, t_st.sim)
        t_bs = torch.as_tensor(np.array(j_bs))
        t_cmd, t_bs = t_env.block.compute(t_act, t_env.env.observe(t_st.replace(sim=t_sim)), t_bs)
        j_cmd, j_bs = j_ctrl(j_sim, j_bs)
        _close(t_cmd, j_cmd, f"command, tick {tick}")
        _close(t_bs, j_bs, f"PD command state, tick {tick}")
        t_sim = t_env.env.engine.step(t_sim, t_cmd)
        j_sim = j_step(j_sim, j_cmd)
        for field in ("q", "v", "u_motor", "a", "contact_forces"):
            tol = TOL_CONTACT if field in ("a", "contact_forces") else TOL
            _close(getattr(t_sim, field), getattr(j_sim, field), f"{field}, tick {tick}", tol)
        for group, x in t_sim.measurements.items():
            tol = TOL_CONTACT if group in ("force", "imu") else TOL
            _close(x, j_sim.measurements[group], f"{group} measurements, tick {tick}", tol)
        touched.append(float(np.abs(np.asarray(j_sim.contact_forces)).max()))
    # The feet touch down within the step: the contacts carry the robot
    assert touched[0] == 0.0 and touched[-1] > 100.0
