"""The port's models, robot assembly and generic ops against jiminy_tpu, on the
CPU at float64 (inputs made with numpy from a seed).

Tolerances: model arrays are built by the same host float64 code, so they
must be equal (atol 0); CRBA, FK and integration reassociate a few products
between jnp.einsum and torch.einsum, so they are held at atol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_torch import convert
from jiminy_torch.envs import assets as t_assets
from jiminy_torch.envs.builders import anymal_standing_pose
from jiminy_torch.hardware import load_hardware_description_file as t_load_hw
from jiminy_torch.models.model import ARRAY_FIELDS, META_FIELDS
from jiminy_torch.models.urdf import build_model_from_urdf as t_build
from jiminy_torch.ops import dynamics as t_dyn
from jiminy_torch.ops import integrate as t_integ
from jiminy_torch.ops import kinematics as t_kin
from jiminy_tpu.envs import assets as j_assets
from jiminy_tpu.hardware import load_hardware_description_file as j_load_hw
from jiminy_tpu.models.urdf import build_model_from_urdf as j_build
from jiminy_tpu.ops import dynamics as j_dyn
from jiminy_tpu.ops import integrate as j_integ
from jiminy_tpu.ops import kinematics as j_kin

RNG = np.random.default_rng(0)


def jax_model_arrays(model) -> dict:
    """Dump a jiminy_tpu RobotModel to numpy (the port cannot import it)."""
    out = {f: getattr(model, f) for f in META_FIELDS}
    out.update({f: np.asarray(getattr(model, f), np.float64) for f in ARRAY_FIELDS})
    return out


def _assert_same_model(t_model, j_model, atol=0.0):
    for f in META_FIELDS:
        assert tuple(np.atleast_1d(getattr(t_model, f))) == tuple(
            np.atleast_1d(getattr(j_model, f))
        ), f
    for f in ARRAY_FIELDS:
        np.testing.assert_allclose(
            getattr(t_model, f), np.asarray(getattr(j_model, f)), atol=atol, rtol=0, err_msg=f
        )


@pytest.fixture(scope="module")
def robots():
    return t_assets.load_robot("anymal"), j_assets.load_robot("anymal")


@pytest.mark.parametrize("freeflyer", [True, False])
def test_urdf_model_matches_jax(freeflyer):
    path = t_assets.urdf_path("anymal")
    _assert_same_model(
        t_build(path, has_freeflyer=freeflyer),
        j_build(path, has_freeflyer=freeflyer, dtype=jnp.float64),
    )


def test_hardware_file_matches_jax():
    path = t_assets.hardware_path("anymal")
    assert t_load_hw(path) == j_load_hw(path)


def test_load_robot_matches_jax(robots):
    tr, jr = robots
    _assert_same_model(tr.model, jr.model)
    assert tr.contact_frame_indices == jr.contact_frame_indices
    assert tr.contact_radii == tuple(jr.contact_radii)
    assert tr.motors.names == jr.motors.names
    assert tr.motors.v_indices == jr.motors.v_indices
    from jiminy_torch.engine.hardware import MOTOR_ARRAY_FIELDS

    for f in MOTOR_ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tr.motors, f), np.asarray(getattr(jr.motors, f)))
    t_groups, j_groups = dict(tr.sensors.groups()), dict(jr.sensors.groups())
    assert set(t_groups) == set(j_groups) == {"encoder", "effort", "imu", "force"}
    assert t_groups["encoder"].q_indices == j_groups["encoder"].q_indices
    assert t_groups["imu"].frame_indices == j_groups["imu"].frame_indices
    assert t_groups["force"].contact_slots == j_groups["force"].contact_slots


def test_model_from_arrays_round_trips(robots):
    tr, jr = robots
    model = convert.model_from_arrays(jax_model_arrays(jr.model), device="cpu", dtype=torch.float64)
    _assert_same_model(model, jr.model)
    again = convert.model_from_arrays({**model.arrays(), **{f: getattr(model, f) for f in META_FIELDS}})
    _assert_same_model(again, tr.model)
    assert torch.equal(model.tensor("mass", "cpu", torch.float64), torch.as_tensor(tr.model.mass))


def test_motor_bank_from_arrays(robots):
    from jiminy_torch.engine.hardware import MOTOR_ARRAY_FIELDS

    tr, jr = robots
    m = jr.motors
    arrays = {f: getattr(m, f) for f in convert.MOTOR_META_FIELDS}
    arrays.update({f: np.asarray(getattr(m, f)) for f in MOTOR_ARRAY_FIELDS})
    bank = convert.motor_bank_from_arrays(arrays)
    cmd = RNG.normal(size=(6, bank.nmotors)) * 100.0
    v = RNG.normal(size=(6, tr.nv)) * 10.0
    u_t, full_t = bank.compute_efforts(torch.as_tensor(cmd), torch.as_tensor(v))
    u_j, full_j = m.compute_efforts(jnp.asarray(cmd), jnp.asarray(v))
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-12, rtol=0)
    np.testing.assert_allclose(full_t.numpy(), np.asarray(full_j), atol=1e-12, rtol=0)


def _random_q(model, batch):
    q = np.tile(anymal_standing_pose(model), (batch, 1))
    q[:, :3] += RNG.normal(size=(batch, 3)) * 0.1
    q[:, 7:] += RNG.normal(size=(batch, model.nq - 7)) * 0.3
    quat = RNG.normal(size=(batch, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    return q


def test_crba_matches_jax(robots):
    tr, jr = robots
    q = _random_q(tr.model, 3)
    np.testing.assert_allclose(
        t_dyn.crba(tr.model, torch.as_tensor(q)).numpy(),
        np.asarray(j_dyn.crba(jr.model, jnp.asarray(q))),
        atol=1e-12, rtol=0,
    )


def test_kinematics_and_integrate_match_jax(robots):
    tr, jr = robots
    q = _random_q(tr.model, 3)
    v = RNG.normal(size=(3, tr.nv))
    a = RNG.normal(size=(3, tr.nv))
    kt = t_kin.forward_kinematics(tr.model, torch.as_tensor(q), torch.as_tensor(v), torch.as_tensor(a))
    kj = j_kin.forward_kinematics(jr.model, jnp.asarray(q), jnp.asarray(v), jnp.asarray(a))
    np.testing.assert_allclose(kt.rot.numpy(), np.asarray(kj.omi.rot), atol=1e-12, rtol=0)
    np.testing.assert_allclose(kt.pos.numpy(), np.asarray(kj.omi.pos), atol=1e-12, rtol=0)
    np.testing.assert_allclose(kt.vel.numpy(), np.asarray(kj.vel), atol=1e-12, rtol=0)
    np.testing.assert_allclose(kt.acc.numpy(), np.asarray(kj.acc), atol=1e-12, rtol=0)
    for f in tr.contact_frame_indices:
        rot, pos = t_kin.frame_placement(tr.model, kt, f)
        pj = j_kin.frame_placement(jr.model, kj, f)
        np.testing.assert_allclose(pos.numpy(), np.asarray(pj.pos), atol=1e-12, rtol=0)
        np.testing.assert_allclose(rot.numpy(), np.asarray(pj.rot), atol=1e-12, rtol=0)
    dv = RNG.normal(size=(3, tr.nv)) * 0.1
    np.testing.assert_allclose(
        t_integ.integrate(tr.model, torch.as_tensor(q), torch.as_tensor(dv)).numpy(),
        np.asarray(j_integ.integrate(jr.model, jnp.asarray(q), jnp.asarray(dv))),
        atol=1e-12, rtol=0,
    )


def test_pd_components_from_jax_arrays_match_the_port():
    """The PD block's constants dumped from jiminy_tpu build the same
    in-kernel controller as the port's own PDController."""
    from jiminy_torch.envs import make as t_make
    from jiminy_tpu.envs import make as j_make

    t_env = t_make("anymal-pid", device="cpu", dtype=torch.float64)
    j_env = j_make("anymal-pid")
    pd, enc = j_env.block, j_env.robot.sensors.encoder
    arrays = {
        "dt": pd._dt, "kp": np.asarray(pd.kp), "kd": np.asarray(pd.kd),
        "state_min": np.asarray(pd._state_min), "state_max": np.asarray(pd._state_max),
        "effort_limit": np.asarray(pd._effort_limit), "reduction": np.asarray(enc.reduction),
        "q_indices": enc.q_indices, "v_indices": enc.v_indices, "joint_side": enc.joint_side,
    }
    got = convert.pd_components_from_arrays(arrays)
    ref = t_env.block.component_controller(t_env.env)
    for f in ("dt", "kp", "kd", "smin", "smax", "eff", "red", "q_indices", "v_indices",
              "joint_side"):
        assert getattr(got, f) == getattr(ref, f), f


def test_add_frame_matches_jax(robots):
    from jiminy_tpu.ops import lie as j_lie

    tr, jr = robots
    rot, pos = np.eye(3)[[1, 2, 0]], np.array([0.1, -0.2, 0.3])
    t_model = tr.model.add_frame("probe", 3, rot, pos)
    j_model = jr.model.add_frame("probe", 3, j_lie.SE3(jnp.asarray(rot), jnp.asarray(pos)))
    _assert_same_model(t_model, j_model)
    assert t_model.frame_index("probe") == t_model.nframes - 1
    assert tr.model.nframes == t_model.nframes - 1
