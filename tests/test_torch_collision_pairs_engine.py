"""The port's engine with collision pairs against jiminy_tpu at float64: one
generic engine period in each contact mode of the fixtures of
`tests/test_self_collision.py` (built by both packages,
`test_torch_collision_pairs.FIXTURES`), jiminy_tpu's jitted `Engine.step`
over the envs by `jax.vmap`, at 1e-10 of each output's scale, the pair
forces and depths (`pair_f_world`, `pair_depth`) of the end state's
evaluation included; and the component core off exactly where jiminy_tpu
turns its fused paths off.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from generic_checks import close_scaled
from jiminy_torch.engine.config import ContactModel as TContactModel
from jiminy_torch.engine.config import ContactOptions as TContactOptions
from jiminy_torch.engine.config import EngineOptions as TEngineOptions
from jiminy_torch.engine.config import StepperOptions as TStepperOptions
from jiminy_torch.engine.config import WorldOptions as TWorldOptions
from jiminy_torch.engine.engine import Engine as TEngine
from jiminy_tpu.engine import Engine as JEngine
from jiminy_tpu.engine import EngineOptions as JEngineOptions
from jiminy_tpu.engine.config import ContactModel as JContactModel
from jiminy_tpu.engine.config import ContactOptions as JContactOptions
from jiminy_tpu.engine.config import StepperOptions as JStepperOptions
from jiminy_tpu.engine.config import WorldOptions as JWorldOptions
from test_torch_collision_pairs import CONTACT, FIXTURES, build_pair, j64, t64

TOL = 1e-10


def _options(constraint: bool, pkg: str):
    cls = {"t": (TEngineOptions, TContactOptions, TStepperOptions, TWorldOptions,
                 TContactModel),
           "j": (JEngineOptions, JContactOptions, JStepperOptions, JWorldOptions,
                 JContactModel)}[pkg]
    engine_opts, contact_opts, stepper, world, contact_model = cls
    contacts = contact_opts(**CONTACT)
    extra = {}
    if constraint:
        contacts = dataclasses.replace(contacts, model=contact_model.CONSTRAINT)
        extra = dict(joint_bounds_mode="constraint")
    return engine_opts(world=world(gravity=(0.0, 0.0, -9.81)), contacts=contacts,
                       stepper=stepper(dt_max=1e-3), controller_update_period=2e-3, **extra)


# Compiling jiminy_tpu's period takes 35-280 s on this CPU for the pairs
# beyond sphere-sphere (the capsule-box search is 32 unrolled iterations):
# those run in the slow tier, their pair forces above in the default one
_SLOW = pytest.mark.slow


@pytest.mark.parametrize("constraint", [False, True], ids=["spring", "constraint"])
@pytest.mark.parametrize("name", ["dumbbell"] + [pytest.param(n, marks=_SLOW)
                                                 for n in ("cross", "capbox", "boxes", "mesh")])
def test_generic_period_with_pairs_matches_jax(name, constraint):
    """One engine period (two RK4 substeps) of a fixture with its pairs and
    the ground under its base's frame, the port's generic path against
    jiminy_tpu's jitted period, and the end state's pair forces and depths."""
    tr, jr = build_pair(name, contact_frames=(FIXTURES[name][1][0]["name"],))
    t_eng = TEngine(tr, _options(constraint, "t"), device="cpu", dtype=torch.float64)
    j_eng = JEngine(jr, _options(constraint, "j").replace(use_fast_dynamics="always"))
    model = tr.model
    rng = np.random.default_rng(11)
    q = np.tile(np.asarray(model.neutral()), (3, 1))
    q[:, 2] = rng.uniform(-0.01, 0.05, size=3)  # the base's point on or into the ground
    q[:, -1] += rng.uniform(-0.1, 0.1, size=3)
    v = rng.normal(size=(3, model.nv)) * 0.3
    t_st = t_eng.reset(t64(q), t64(v))
    j_st = jax.jit(jax.vmap(lambda q_, v_: j_eng.reset(q_, v_)))(j64(q), j64(v))
    t_out = t_eng.step(t_st)
    j_out = jax.jit(jax.vmap(j_eng.step))(j_st)
    fields = ["q", "v", "a", "contact_forces"] + (["lam"] if constraint else [])
    for f in fields:
        close_scaled(getattr(t_out, f), getattr(j_out, f), tol=TOL, msg=f"{name} {f}")
    cmd = np.zeros((3, 0))
    _, t_aux = t_eng.dynamics_full(t_out.t, t_out.q, t_out.v, t64(cmd),
                                   t_eng._carry_of(t_out) if constraint else None)
    carry = ({k: getattr(j_out, k) for k in ("lam", "contact_active", "bound_active",
                                               "distance_ref")} if constraint else None)
    _, j_aux = jax.jit(jax.vmap(lambda t, q_, v_, c, cc: j_eng.dynamics_full(t, q_, v_, c, cc)))(
        j_out.t, j_out.q, j_out.v, j64(cmd), carry)
    for k in ("pair_f_world", "pair_depth"):
        close_scaled(t_aux[k], j_aux[k], tol=TOL, msg=f"{name} {k}")


def test_pairs_turn_the_component_core_off_where_jiminy_tpu_does():
    """With pairs, no component core in either mode (jiminy_tpu builds its
    constrained CRBA core `_cdyn_cm` but turns every fused path off, which
    is the port's `_cdyn_cm`); without pairs the core is on in both."""
    for constraint in (False, True):
        tr, jr = build_pair("dumbbell", contact_frames=("baseF",))
        j_opts = _options(constraint, "j").replace(use_fast_dynamics="always")
        t_eng = TEngine(tr, _options(constraint, "t"), device="cpu")
        j_eng = JEngine(jr, j_opts)
        assert t_eng._cdyn is None and j_eng._cdyn is None
        assert t_eng._cdyn_cm is None and not t_eng._use_core()
        tr0 = dataclasses.replace(tr, collision_pairs_geom=())
        jr0 = jr.replace(collision_pairs_geom=())
        t0, j0 = TEngine(tr0, _options(constraint, "t"), device="cpu"), JEngine(jr0, j_opts)
        assert (t0._cdyn is None) == (j0._cdyn is None)
        assert (t0._cdyn_cm is None) == (j0._cdyn_cm is None)
        assert t0._use_core()
