"""One engine period of the ANYmal (`anymal-pid`'s robot and options) on the
port's generic path (`use_fast_dynamics=False`: generic FK, contact forces,
penalty bounds, ABA; or the array-form PGS solve with the warm start chained
through every RK4 stage) against jiminy_tpu's jitted engine period, which
takes its generic path on the CPU, at float64, in spring-damper contact mode
here and in constraint contact mode in
`tests/test_torch_generic_engine_cm.py`.

The states are `testing.constrained_inputs`' (numpy, seeded): feet 0-3 cm
into the ground, a quarter of the envs past a joint bound, random
velocities, commands, warm starts and active sets. Every output is held to
1e-10 of its own scale (max |port - jiminy_tpu| <= 1e-10 (1 + max
|jiminy_tpu|)): the contact springs reach some 3e4 N on these states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from generic_checks import close_scaled
from jiminy_torch.envs import make as t_make
from jiminy_torch.testing import constrained_inputs, constraint_mode_options
from jiminy_tpu.engine import config as j_config
from jiminy_tpu.envs import make as j_make

TOL = 1e-10


def anymal_engines(constraint: bool):
    """(port engine on the generic path, jiminy_tpu engine, a constraint-mode
    port env for the inputs)."""
    base = t_make("anymal-pid", device="cpu", dtype=torch.float64).engine.options
    cm_opts = constraint_mode_options(base)
    cm_env = t_make("anymal-pid", device="cpu", dtype=torch.float64, options=cm_opts)
    opts = (cm_opts if constraint else base).replace(use_fast_dynamics=False)
    t_eng = t_make("anymal-pid", device="cpu", dtype=torch.float64, options=opts).env.engine
    j_env = j_make("anymal-pid").env
    j_opts = j_env.engine.options
    if constraint:
        j_opts = j_opts.replace(
            contacts=dataclasses.replace(j_opts.contacts, model=j_config.ContactModel.CONSTRAINT),
            joint_bounds_mode="constraint",
        )
    j_eng = type(j_env.engine)(j_env.robot, j_opts)
    assert t_eng._cdyn is None and t_eng._cdyn_cm is None and not t_eng.supports_fused_rollout
    assert j_eng._cdyn is None and j_eng._cdyn_cm is None  # jiminy_tpu's generic path
    return t_eng, j_eng, cm_env


def check_period(constraint: bool, seed: int):
    t_eng, j_eng, cm_env = anymal_engines(constraint)
    q, v, cmd, sol = (x.numpy() for x in constrained_inputs(cm_env, 2, seed=seed))
    t_st = t_eng.reset(torch.as_tensor(q), torch.as_tensor(v))
    j_st = jax.jit(jax.vmap(lambda q_, v_: j_eng.reset(q_, v_)))(jnp.asarray(q), jnp.asarray(v))
    if constraint:  # the inputs' warm start and active sets
        n, nc = t_eng.cset.total_rows, t_eng.cset.n_contacts
        lam, cact, bact = sol[:, :n], sol[:, n:n + nc] > 0.5, sol[:, n + nc:] > 0.5
        t_st = t_st.replace(lam=torch.as_tensor(lam), contact_active=torch.as_tensor(cact),
                            bound_active=torch.as_tensor(bact))
        j_st = j_st.replace(lam=jnp.asarray(lam), contact_active=jnp.asarray(cact),
                            bound_active=jnp.asarray(bact))
    for name in ("a", "contact_forces"):
        close_scaled(getattr(t_st, name), getattr(j_st, name), tol=TOL, msg=f"reset {name}")
    t_out = t_eng.step(t_st, torch.as_tensor(cmd))
    j_out = jax.jit(jax.vmap(j_eng.step))(j_st, jnp.asarray(cmd))
    assert float(np.abs(t_out.contact_forces.numpy()).max()) > 10.0
    fields = ["q", "v", "a", "u_motor", "contact_forces", "t"]
    if constraint:
        fields += ["lam", "contact_active", "bound_active"]
        assert bool(t_out.contact_active.any())
    for name in fields:
        close_scaled(getattr(t_out, name), getattr(j_out, name), tol=TOL, msg=name)
    for group, meas in t_out.measurements.items():
        close_scaled(meas, j_out.measurements[group], tol=TOL, msg=group)


def test_anymal_generic_period_matches_jax():
    check_period(constraint=False, seed=11)
