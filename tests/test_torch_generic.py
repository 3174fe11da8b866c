"""The port's generic dynamics path, function by function, against
jiminy_tpu on the CPU at float64 (inputs made with numpy from a seed;
shared checks in `tests/generic_checks.py`):

- the joint maps of every joint type (free-flyer, revolute, continuous
  (cos, sin), prismatic, spherical quaternion);
- over whole models, `integrate`, `difference`, `normalize`, `rnea` (with
  external forces), `nonlinear_effects`, `aba` (with external forces),
  `crba`, the kinetic and potential energies, the joint-space and frame
  Jacobians and the world-aligned frame velocity, on the three toys and on
  random chains with spherical and continuous joints
  (`tests/test_dynamics.py::random_chain_model`), carried across through
  `convert.model_from_arrays`. The ANYmal and the Atlas are in
  `tests/test_torch_generic_robots.py`, the contacts, constraint rows and
  the PGS solve in `tests/test_torch_generic_contacts.py`.

Tolerance 1e-12 absolute: the port mirrors jiminy_tpu op for op, but
jnp.einsum and torch.einsum may sum in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generic_checks import (
    B,
    CHAINS,
    as_np,
    check_configuration_maps,
    check_dynamics,
    check_jacobians,
    check_models_carry_across,
    close,
    make_case,
)
from jiminy_torch.models import joints as t_jt
from jiminy_tpu.models import joints as j_jt

@pytest.mark.parametrize("jtype", list(t_jt.JointType), ids=lambda t: t.name)
def test_joint_maps_match_jax(jtype):
    rng = np.random.default_rng(int(jtype))
    nq, nv = t_jt.JOINT_NQ[jtype], t_jt.JOINT_NV[jtype]
    assert (nq, nv) == (j_jt.JOINT_NQ[j_jt.JointType(int(jtype))], j_jt.JOINT_NV[j_jt.JointType(int(jtype))])
    np.testing.assert_array_equal(t_jt.neutral_q(jtype), j_jt.neutral_q(j_jt.JointType(int(jtype))))
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    neutral = np.tile(t_jt.neutral_q(jtype), (B, 1))
    dv0, dv1 = rng.normal(size=(B, nv)), rng.normal(size=(B, nv)) * 0.7
    q0 = as_np(j_jt.integrate_joint(jtype, jnp.asarray(neutral), jnp.asarray(dv0)))
    q1 = as_np(j_jt.integrate_joint(jtype, jnp.asarray(q0), jnp.asarray(dv1)))
    tq0, tq1 = torch.as_tensor(q0), torch.as_tensor(q1)
    close(t_jt.integrate_joint(jtype, tq0, torch.as_tensor(dv1)), q1)
    close(t_jt.difference_joint(jtype, tq0, tq1),
           j_jt.difference_joint(jtype, jnp.asarray(q0), jnp.asarray(q1)))
    noisy = q1 * 1.1
    close(t_jt.normalize_joint(jtype, torch.as_tensor(noisy)),
           j_jt.normalize_joint(jtype, jnp.asarray(noisy)))
    rot, pos = t_jt.joint_transform(jtype, torch.as_tensor(axis), tq0)
    want = j_jt.joint_transform(jtype, jnp.asarray(axis), jnp.asarray(q0))
    close(rot, np.broadcast_to(as_np(want.rot), (B, 3, 3)))
    close(pos, np.broadcast_to(as_np(want.pos), (B, 3)))
    close(t_jt.motion_subspace(jtype, torch.as_tensor(axis)),
           j_jt.motion_subspace(jtype, jnp.asarray(axis)), atol=0.0)


@pytest.fixture(scope="module", params=("cartpole", "acrobot", "simple_pendulum")
                + tuple(c[0] for c in CHAINS))
def case(request):
    return make_case(request.param)


def test_models_carry_across(case):
    check_models_carry_across(case)


def test_configuration_maps_match_jax(case):
    check_configuration_maps(case)


def test_dynamics_match_jax(case):
    check_dynamics(case)


def test_jacobians_match_jax(case):
    check_jacobians(case)
