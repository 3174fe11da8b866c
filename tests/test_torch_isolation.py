"""The port stands alone, refuses what it has not ported, and never falls back
from a kernel to its plain version."""

import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jiminy_torch
from jiminy_torch.engine.config import (
    ContactModel,
    ContactOptions,
    EngineOptions,
    IntegratorType,
    StepperOptions,
    WorldOptions,
)
from jiminy_torch.engine import solver
from jiminy_torch.envs import make
from jiminy_torch.ops import cdyn, kernels
from jiminy_torch.testing import (
    column_errors,
    column_quantile_errors,
    constrained_inputs,
    constraint_mode_options,
    perturbed_states,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(jiminy_torch.__path__, prefix="jiminy_torch.")
    )


def test_port_imports_neither_jax_nor_jiminy_tpu():
    mods = _port_modules()
    assert "jiminy_torch.ops.cdyn" in mods and "jiminy_torch.envs.anymal" in mods
    assert "jiminy_torch.engine.solver" in mods and "jiminy_torch.engine.constraints" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'jiminy_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_neither_jax_nor_jiminy_tpu():
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert names and not [n for n in names if n.split(".")[0] in ("jax", "jiminy_tpu")]


@pytest.fixture(scope="module")
def env():
    return make("anymal-pid", device="cpu", dtype=torch.float64)


def test_make_without_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make("anymal-pid")
    monkeypatch.setattr(kernels, "_LIBRARY", None)
    with pytest.raises(RuntimeError, match="CUDA device"):
        kernels.load()


def test_kernel_wrappers_raise_instead_of_falling_back(env):
    eng = env.env.engine
    q, v, tau = perturbed_states(env, 2, seed=0)
    cd = eng._cdyn
    # The kernel entry points refuse tensors they cannot launch on...
    with pytest.raises(ValueError, match="CUDA tensors"):
        cd.accel_kernel(q, v, tau)
    with pytest.raises(ValueError, match="CUDA tensors"):
        eng._get_period_run("rk4").kernel(q, v, torch.zeros((2, 12), dtype=q.dtype))
    ctrl = cdyn.ZOHPassThrough(12)
    run = eng._get_rollout_run("zoh-test", ctrl, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        run.kernel(q, v, torch.zeros((2, 12), dtype=q.dtype), torch.zeros((2, 0), dtype=q.dtype))
    # ...and the device router neither guesses nor falls back.
    with pytest.raises(ValueError, match="no kernel and no plain version"):
        cd.accel(q.to("meta"), v.to("meta"), tau.to("meta"))
    assert all(k.launches == 0 for k in cdyn.KERNELS.values())


def test_unported_options_raise_not_implemented(env):
    robot = env.robot
    stepper = StepperOptions(integrator=IntegratorType.RUNGE_KUTTA_DOPRI)
    base = dict(joint_bounds_mode="penalty")
    for opts in (
        EngineOptions(use_fast_dynamics=False, **base),
        EngineOptions(stepper=stepper, contacts=ContactOptions(model=ContactModel.CONSTRAINT),
                      joint_bounds_mode="constraint"),
        EngineOptions(joint_bounds_mode="constraint"),
        EngineOptions(world=WorldOptions(ground_profile=lambda xy: (0.0, (0.0, 0.0, 1.0))), **base),
    ):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            type(env.env.engine)(robot, opts, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make("anymal-pid", device="cpu", std_ratio=0.5)


def test_packed_constants_match_model(env):
    eng = env.env.engine
    cd = eng._cdyn
    packed = cd.pack(eng._tau_c, 1e-3, eng._imu_frames, "cpu", torch.float64)
    ci, cf = packed.ci.numpy(), packed.cf.numpy()
    model = env.robot.model
    nj, nv, nc, ni, nm = model.njoints, model.nv, 4, 1, 12
    assert list(ci[:9]) == [nj, model.nq, nv, nc, ni, nm, len(eng._bound_gains), 1, 1]
    joints = ci[cdyn.CI_HEADER:cdyn.CI_HEADER + cdyn.CI_JOINT * nj].reshape(nj, 4)
    assert tuple(joints[:, 0]) == model.parents
    assert tuple(joints[:, 1]) == model.joint_types
    assert tuple(joints[:, 2]) == model.idx_q and tuple(joints[:, 3]) == model.idx_v
    jf = cf[cdyn.CF_HEADER:cdyn.CF_HEADER + cdyn.CF_JOINT * nj].reshape(nj, cdyn.CF_JOINT)
    np.testing.assert_array_equal(jf[:, :9].reshape(nj, 3, 3), model.jplacement_rot)
    np.testing.assert_array_equal(jf[:, 9:12], model.jplacement_pos)
    np.testing.assert_array_equal(jf[:, 12:15], model.joint_axes)
    np.testing.assert_array_equal(jf[:, 21:].reshape(nj, 6, 6)[:, 3:, 3:],
                                  model.mass[:, None, None] * np.eye(3))
    off = cdyn.CF_HEADER + cdyn.CF_JOINT * nj
    np.testing.assert_array_equal(cf[off:off + nv], model.armature)
    np.testing.assert_array_equal(cf[:3], eng.options.world.gravity)
    np.testing.assert_array_equal(cf[8:11], [1e-3, 0.5e-3, 1e-3 / 6.0])
    off_c = cdyn.CI_HEADER + cdyn.CI_JOINT * nj
    contacts = ci[off_c:off_c + cdyn.CI_CONTACT * nc].reshape(nc, 2)
    assert tuple(contacts[:, 0]) == tuple(model.frame_parents[f] for f in env.robot.contact_frame_indices)
    off_m = off_c + cdyn.CI_CONTACT * nc + cdyn.CI_IMU * ni
    motors = ci[off_m:off_m + cdyn.CI_MOTOR * nm].reshape(nm, 3)
    assert tuple(motors[:, 0]) == env.robot.motors.v_indices
    assert set(motors[:, 1]) == {cdyn.MOTOR_ENVELOPE}
    assert packed.counts == dict(nj=nj, nq=model.nq, nv=nv, nc=nc, ni=ni, nm=nm,
                                 nb=len(eng._bound_gains))


def test_kernel_build_is_sm90a_without_fast_math():
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    assert not any("fast" in f for f in kernels.NVCC_FLAGS)
    assert kernels.SOURCE.exists() and all(h.exists() for h in kernels.HEADERS)
    src = kernels.SOURCE.read_text()
    for entry in ("cdyn_accel_", "cdyn_period_", "cdyn_rollout_", "cdyn_period_cm_",
                  "cdyn_rollout_cm_"):
        assert f"int {entry}##SUFFIX" in src
    assert set(kernels._SIGNATURES) == set(cdyn.KERNELS)


def test_pack_cache_holds_the_transmission_it_was_built_for(env):
    eng = env.env.engine
    cd = eng._cdyn
    packed = cd.pack(eng._tau_c, 1e-3, eng._imu_frames, "cpu", torch.float64)
    assert cd.pack(eng._tau_c, 1e-3, eng._imu_frames, "cpu", torch.float64) is packed
    other = dataclasses.replace(eng._tau_c)
    assert cd.pack(other, 1e-3, eng._imu_frames, "cpu", torch.float64) is not packed
    assert any(key[0] is eng._tau_c for key in cd._packed)


def _columns_ref(seed=0, batch=2000):
    rng = np.random.default_rng(seed)
    # Columns of very different scales, as in the kernels' extras
    return torch.as_tensor(rng.normal(size=(batch, 4)) * np.array([1e-3, 1.0, 75.0, 4e3]))


@pytest.mark.parametrize("fault", ["zeroed", "half_wrong", "scaled_1pct"])
def test_column_errors_catch_a_faulty_small_column(fault):
    ref = _columns_ref()
    out = ref.clone()
    if fault == "zeroed":
        out[:, 0] = 0.0
    elif fault == "half_wrong":
        out[::2, 0] *= -1.0
    else:
        out[:, 0] *= 1.01
    # float64 measure: per column, max |out - ref| / (1 + max |ref|)
    assert float(column_errors(out, ref).max()) > 1e-9
    assert float(column_errors(out, ref)[1:].max()) == 0.0
    # float32 measure: per column, q90 of |out - ref| / RMS, against 1e-2
    q90 = column_quantile_errors(out, ref, 0.9)
    assert float(q90[0]) >= (5e-3 if fault == "scaled_1pct" else 1.0)
    assert float(q90[1:].max()) == 0.0


def test_column_quantile_errors_pass_rare_outlier_envs():
    ref = _columns_ref()
    out = ref.clone() * (1.0 + 1e-6)
    out[7, 2] = -out[7, 2]  # one env of 2000 flipped
    assert float(column_quantile_errors(out, ref, 0.9).max()) < 1e-5
    assert float(column_errors(out, ref)[2]) > 1e-2


@pytest.fixture(scope="module")
def cm_env(env):
    return make("anymal-pid", device="cpu", dtype=torch.float64,
                options=constraint_mode_options(env.engine.options))


def test_constrained_wrappers_raise_instead_of_falling_back(cm_env):
    eng = cm_env.engine
    q, v, cmd, sol = constrained_inputs(cm_env, 2, seed=0)
    cc = torch.cat([cmd, sol], dim=-1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        eng._get_period_run("rk4").kernel(q, v, cc)
    run = eng._get_rollout_run("zoh-test", cdyn.ZOHPassThrough(12), 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        run.kernel(q, v, cmd, sol)
    with pytest.raises(ValueError, match="no kernel and no plain version"):
        eng._get_period_run("rk4")(q.to("meta"), v.to("meta"), cc.to("meta"))
    assert all(k.launches == 0 for k in cdyn.KERNELS.values())


def test_unported_constraint_rows_and_terrain_raise_not_implemented(cm_env):
    """Distance-loop and rolling rows (ROADMAP item 10), sphere contacts and
    terrain (item 13) are refused, on every path that would assemble them."""
    eng = cm_env.engine
    cd, opts = eng._cdyn_cm, eng._solver_opts
    for cset in (
        dataclasses.replace(eng.cset, distance_pairs=((89, 123),)),
        dataclasses.replace(eng.cset, sphere_specs=((89, 0.02),)),
        dataclasses.replace(eng.cset, wheel_specs=((89, 0.02, (0.0, 1.0, 0.0)),)),
    ):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 10"):
            solver.ConstrainedPeriodIntegrator(cd, eng._tau_c, cset, opts, 1e-3, 1, "rk4", 12, ())
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 10"):
            solver.pack_constraints(cd, cset, opts, "cpu", torch.float64)
    spheres = dataclasses.replace(eng.cset, contact_radii=(0.02,) * 4)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 3"):
        solver.constraint_system_components(cd, spheres, *([None] * 6), 1.0, 1.0, 1e-3, [], [])
    terrain = cm_env.engine.options.replace(
        world=WorldOptions(ground_profile=lambda xy: (0.0, (0.0, 0.0, 1.0)))
    )
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 13"):
        type(eng)(cm_env.robot, terrain, device="cpu")


def test_packed_constraint_constants_match_model(cm_env):
    eng = cm_env.engine
    model, cset, o = cm_env.robot.model, eng.cset, eng._solver_opts
    packed = solver.pack_constraints(eng._cdyn_cm, cset, o, "cpu", torch.float64)
    si, sf = packed.si.numpy(), packed.sf.numpy()
    assert list(si[:6]) == [28, 12, 4, o.iter_max, 1, 9]  # 9: the widest support
    bounds = si[solver.SI_HEADER:solver.SI_HEADER + 2 * 12].reshape(12, 2)
    assert tuple(bounds[:, 0]) == tuple(model.idx_q[j] for j in cset.bound_joint_indices)
    assert tuple(bounds[:, 1]) == tuple(model.idx_v[j] for j in cset.bound_joint_indices)
    contacts = si[solver.SI_HEADER + 24:solver.SI_HEADER + 36].reshape(4, 3)
    assert tuple(contacts[:, 0]) == tuple(
        model.frame_parents[f] for f in cset.contact_frame_indices
    )
    for parent, n_sup, off in contacts:  # support dofs: 6 base + 3 leg dofs
        assert list(si[off:off + n_sup]) == solver.support_dofs(eng._cdyn_cm, parent)
    assert len(si) == solver.SI_HEADER + 36 + 4 * 9
    np.testing.assert_array_equal(sf[:7], [o.kp, o.kd, o.friction, o.torsion, o.regularization,
                                           1e-11, o.transition_eps])
    relax = sf[solver.SF_HEADER:solver.SF_HEADER + o.iter_max]
    assert list(relax) == [solver._relaxation(it, o.iter_max) for it in range(o.iter_max)]
    assert relax[0] == 1.0 and relax[-1] == 0.01
    off = solver.SF_HEADER + o.iter_max
    lim = sf[off:off + 4 * 12].reshape(12, 4)
    qi = bounds[:, 0]
    np.testing.assert_array_equal(lim[:, 0], model.position_limit_lower[qi])
    np.testing.assert_array_equal(lim[:, 1], model.position_limit_upper[qi])
    np.testing.assert_array_equal(lim[:, 2], model.position_limit_lower[qi] + o.transition_eps)
    frames = sf[off + 48:].reshape(4, 12)
    np.testing.assert_array_equal(frames[:, :3], model.fplacement_pos[list(cset.contact_frame_indices)])
