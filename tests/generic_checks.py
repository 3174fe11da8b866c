"""Shared inputs and checks of the port's generic-path tests
(`tests/test_torch_generic*.py`): jiminy_tpu's functions are the reference,
batched over the envs by `jax.vmap`, the inputs made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from jiminy_torch import convert
from jiminy_torch.envs import assets as t_assets
from jiminy_torch.models import joints as t_jt
from jiminy_torch.models.model import ARRAY_FIELDS, META_FIELDS
from jiminy_torch.ops import cdyn as t_cdyn
from jiminy_torch.ops import dynamics as t_dyn
from jiminy_torch.ops import integrate as t_integ
from jiminy_torch.ops import kinematics as t_kin
from jiminy_tpu.envs import assets as j_assets
from jiminy_tpu.ops import dynamics as j_dyn
from jiminy_tpu.ops import integrate as j_integ
from jiminy_tpu.ops import kinematics as j_kin
from test_dynamics import random_chain_model

# The dynamics and kinematics are held at 1e-12 absolute; outputs that
# carry stiff springs at 1e-12 of their own scale (`close_scaled`)
ATOL = 1e-12
GRAVITY = np.array([0.0, 0.0, -9.81])
B = 3


def as_np(x):
    return np.array(x, np.float64)


def close(got, want, atol=ATOL, rtol=0.0, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, as_np(want), atol=atol, rtol=rtol, err_msg=msg)


def close_scaled(got, want, tol=ATOL, msg=""):
    """max |got - want| <= tol (1 + max |want|)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = as_np(want)
    assert got.shape == want.shape, msg
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = 1.0 + (float(np.abs(want).max()) if want.size else 0.0)
    assert err <= tol * scale, f"{msg}: {err} > {tol} x {scale}"


def vmapped(fn, *args):
    """jiminy_tpu's function over the env batch: its ops are written for one
    env and batched by `jax.vmap`."""
    return jax.vmap(fn)(*(jnp.asarray(a) for a in args))


def model_arrays(model) -> dict:
    out = {f: getattr(model, f) for f in META_FIELDS}
    out.update({f: as_np(getattr(model, f)) for f in ARRAY_FIELDS})
    return out


# --------------------------------------------------------------------------- #
# Whole-model generic ops
# --------------------------------------------------------------------------- #

ROBOTS = ("anymal", "atlas", "cartpole", "acrobot", "simple_pendulum")
CHAINS = (("chain-fixed", 6, False, 3), ("chain-free", 7, True, 4), ("chain-long", 9, False, 11))


def models_of(name):
    """(port model, jiminy_tpu model) of a packaged robot or a random chain
    carried across through its arrays."""
    for cname, n, free, seed in CHAINS:
        if name == cname:
            jm = random_chain_model(n, free_root=free, seed=seed)
            return convert.model_from_arrays(model_arrays(jm)), jm
    free = None if name in ("anymal", "atlas") else False
    return (t_assets.load_robot(name, has_freeflyer=free).model,
            j_assets.load_robot(name, has_freeflyer=free).model)


def inputs_of(jm, seed):
    rng = np.random.default_rng(seed)
    neutral = np.tile(as_np(jm.neutral()), (B, 1))
    q = as_np(vmapped(lambda q, d: j_integ.integrate(jm, q, d), neutral, rng.normal(size=(B, jm.nv)) * 0.5))
    v, a, tau = (rng.normal(size=(B, jm.nv)) for _ in range(3))
    fext = rng.normal(size=(B, jm.njoints, 6)) * 5.0
    return q, v, a, tau, fext


def make_case(name):
    tm, jm = models_of(name)
    return name, tm, jm, inputs_of(jm, seed=len(name))


def check_models_carry_across(case):
    name, tm, jm, _ = case
    for f in META_FIELDS:
        assert tuple(np.atleast_1d(getattr(tm, f))) == tuple(np.atleast_1d(getattr(jm, f))), f
    for f in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tm, f), as_np(getattr(jm, f)), err_msg=f)
    types = set(tm.joint_types)
    if name.startswith("chain"):  # the chains hold the joint types the core refuses
        assert types & {int(t_jt.JointType.SPHERICAL), int(t_jt.JointType.REVOLUTE_UNBOUNDED)}
    core = not types & {int(t_jt.JointType.SPHERICAL), int(t_jt.JointType.REVOLUTE_UNBOUNDED)}
    assert t_cdyn.supports_model(tm) == core


def check_configuration_maps(case):
    _, tm, jm, (q, v, *_rest) = case
    tq, dv = torch.as_tensor(q), torch.as_tensor(v) * 0.3
    q1 = t_integ.integrate(tm, tq, dv)
    close(q1, vmapped(lambda q, d: j_integ.integrate(jm, q, d), q, v * 0.3))
    close(t_integ.difference(tm, tq, q1),
           vmapped(lambda a, b: j_integ.difference(jm, a, b), q, q1.numpy()))
    close(t_integ.normalize(tm, tq * 1.01), vmapped(lambda x: j_integ.normalize(jm, x), q * 1.01))


def check_dynamics(case):
    _, tm, jm, (q, v, a, tau, fext) = case
    tq, tv, ta, ttau, tf = (torch.as_tensor(x) for x in (q, v, a, tau, fext))
    g = torch.as_tensor(GRAVITY)
    jg = jnp.asarray(GRAVITY)
    close(t_dyn.crba(tm, tq), vmapped(lambda q: j_dyn.crba(jm, q), q), msg="crba")
    close(t_dyn.rnea(tm, g, tq, tv, ta, tf),
           vmapped(lambda *x: j_dyn.rnea(jm, jg, *x), q, v, a, fext), msg="rnea")
    close(t_dyn.nonlinear_effects(tm, g, tq, tv),
           vmapped(lambda *x: j_dyn.nonlinear_effects(jm, jg, *x), q, v), msg="nle")
    close(t_dyn.aba(tm, g, tq, tv, ttau),
           vmapped(lambda *x: j_dyn.aba(jm, jg, *x), q, v, tau), msg="aba")
    close(t_dyn.aba(tm, g, tq, tv, ttau, tf),
           vmapped(lambda *x: j_dyn.aba(jm, jg, *x), q, v, tau, fext), msg="aba fext")
    close(t_dyn.kinetic_energy(tm, tq, tv),
           vmapped(lambda *x: j_dyn.kinetic_energy(jm, *x), q, v), msg="kinetic")
    close(t_dyn.potential_energy(tm, g, tq),
           vmapped(lambda x: j_dyn.potential_energy(jm, jg, x), q), msg="potential")
    # ABA inverts RNEA, through the port alone
    close(t_dyn.rnea(tm, g, tq, tv, t_dyn.aba(tm, g, tq, tv, ttau, tf), tf), tau, atol=1e-9)


def check_jacobians(case):
    _, tm, jm, (q, v, a, *_rest) = case
    tkin = t_kin.forward_kinematics(tm, torch.as_tensor(q), torch.as_tensor(v),
                                    torch.as_tensor(a))
    jkin = vmapped(lambda *x: j_kin.forward_kinematics(jm, *x), q, v, a)
    close(tkin.rot, jkin.omi.rot)
    close(tkin.vel, jkin.vel)
    close(tkin.acc, jkin.acc)
    tjac = t_kin.joint_space_jacobian(tm, tkin)
    jjac = jax.vmap(lambda k: j_kin.joint_space_jacobian(jm, k))(jkin)
    close(tjac, jjac, msg="J")
    frames = sorted({0, tm.nframes // 2, tm.nframes - 1})
    for f in frames:
        close(t_kin.frame_jacobian_world_aligned(tm, tkin, tjac, f),
               jax.vmap(lambda k, j: j_kin.frame_jacobian_world_aligned(jm, k, j, f))(jkin, jjac),
               msg=f"frame {f} jacobian")
        close(t_kin.frame_velocity_world_aligned(tm, tkin, f),
               jax.vmap(lambda k: j_kin.frame_velocity_world_aligned(jm, k, f))(jkin),
               msg=f"frame {f} velocity")
    for j in range(tm.njoints):
        assert t_kin.ancestor_dof_mask(tm, j) == j_kin.ancestor_dof_mask(jm, j)


