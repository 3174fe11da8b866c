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
from jiminy_torch.engine import engine as engine_mod
from jiminy_torch.engine import solver
from jiminy_torch.envs import make
from jiminy_torch.ops import cdyn, kernels
from jiminy_torch.utils import terrain
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
    assert "jiminy_torch.envs.bipeds" in mods and "jiminy_torch.envs.builders_bipeds" in mods
    assert "jiminy_torch.engine.contact" in mods and "jiminy_torch.envs.toys" in mods
    assert "jiminy_torch.models.urdf" in mods and "jiminy_torch.envs.assets" in mods
    assert "jiminy_torch.envs.ant" in mods and "jiminy_torch.engine.robot" in mods
    assert "jiminy_torch.engine.internal" in mods and "jiminy_torch.envs.builders" in mods
    assert "jiminy_torch.engine.merge" in mods and "jiminy_torch.engine.multi" in mods
    for m in ("rl.ppo", "rl.evaluate", "rl.checkpoint", "rl.networks", "gym.wrappers",
              "telemetry.trajectory", "utils", "utils.terrain"):
        assert f"jiminy_torch.{m}" in mods, m
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
    from jiminy_torch import envs

    assert not hasattr(envs, "_NOT_PORTED") and "ant" in envs._REGISTRY
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("anymal-pid", "ant"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(name)
    monkeypatch.setattr(kernels, "_LIBRARY", None)
    with pytest.raises(RuntimeError, match="CUDA device"):
        kernels.load()


def test_multi_simulator_is_refused_naming_its_item():
    """The multi-robot engine is ported; the simulator facade over it is
    not (ROADMAP.md queue 1 item 14)."""
    from jiminy_torch.engine.multi import MultiRobotEngine, MultiSimulator

    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 14"):
        MultiSimulator({})
    assert callable(MultiRobotEngine.register_collision_pair)


def test_new_modules_import_neither_jax_nor_jiminy_tpu():
    """The collision pairs, the multi-robot engine and the look-alike
    builders, imported alone, load neither JAX nor jiminy_tpu."""
    mods = ["jiminy_torch.engine.merge", "jiminy_torch.engine.multi",
            "jiminy_torch.engine.contact", "jiminy_torch.envs.builders_bipeds",
            "jiminy_torch.envs.builders"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'jiminy_tpu'))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_unported_training_options_raise_not_implemented():
    from jiminy_torch.rl import PPOConfig, make_train, train

    toy = make("cartpole", device="cpu", dtype=torch.float64)
    cfg = PPOConfig(n_envs=2, n_steps=2, total_iterations=1)
    for fn in (make_train, train):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 15"):
            fn(toy, cfg, mesh=object())
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 12"):
            fn(toy, cfg, curriculum=object())


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


def _user_ground(xy):
    """A ground profile as a plain callable: no packed form."""
    return xy[..., 0] * 0.0, torch.tensor([0.0, 0.0, 1.0], dtype=xy.dtype).expand(
        xy.shape[:-1] + (3,))


def test_unported_options_raise_not_implemented(env):
    robot = env.robot
    stepper = StepperOptions(integrator=IntegratorType.RUNGE_KUTTA_DOPRI)
    base = dict(joint_bounds_mode="penalty")
    # use_fast_dynamics=False is the generic path now, not a refusal
    generic = type(env.env.engine)(robot, EngineOptions(use_fast_dynamics=False, **base),
                                   device="cpu")
    assert generic._cdyn is None and not generic.supports_fused_rollout
    for opts in (
        EngineOptions(stepper=stepper, contacts=ContactOptions(model=ContactModel.CONSTRAINT),
                      joint_bounds_mode="constraint"),
        EngineOptions(stepper=stepper, joint_bounds_mode="constraint"),
    ):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            type(env.env.engine)(robot, opts, device="cpu")
    # Joint bounds through the solver beside the spring-damper feet are ported
    beside = type(env.env.engine)(robot, EngineOptions(joint_bounds_mode="constraint"),
                                  device="cpu")
    assert beside._cdyn_cm.has_contacts and beside.cset.n_bounds == 12
    # A ground profile builds on every path; one without a packed form runs
    # on the CPU only, and is refused for the card (the routing decision,
    # taken before any tensor reaches a device)
    packed = terrain.random_perlin_ground(1.5, 0.05, seed=3)
    for ground in (packed, _user_ground):
        for extra in ({}, dict(use_fast_dynamics=False)):
            opts = EngineOptions(world=WorldOptions(ground_profile=ground), **base, **extra)
            eng = type(env.env.engine)(robot, opts, device="cpu")
            assert eng.ground_fn is ground
            assert eng._cdyn is None or eng._cdyn.ground_fn is ground
    card = torch.device("cuda", 0)
    user = EngineOptions(world=WorldOptions(ground_profile=_user_ground), **base)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2 item 6"):
        engine_mod._refuse_unported(robot, user, card)
    engine_mod._refuse_unported(robot, user.replace(world=WorldOptions(ground_profile=packed)),
                                card)
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
                                 nb=len(eng._bound_gains), nsph=0)


def test_packed_terrain_section_matches_pack_ground(env):
    """The model's buffers carry the ground's program after the spring
    section (header slots CI_TERRAIN, CI_TERRAIN + 1: its offsets in ci and
    cf), the buffers otherwise as on flat ground; flat ground has none."""
    eng = env.env.engine
    flat = eng._cdyn.pack(eng._tau_c, 1e-3, eng._imu_frames, "cpu", torch.float64)
    ground = terrain.sum_heightmaps([terrain.random_perlin_ground(1.5, 0.05, seed=3),
                                     terrain.periodic_stairs_ground(0.4, 0.03, 3, 0.5)])
    cd = cdyn.ComponentDynamics(
        env.robot.model, eng._cdyn.gravity, contact_opts=eng._cdyn.contact_opts,
        contact_frames=eng._cdyn.contact_frames, contact_radii=eng._cdyn.contact_radii,
        bound_gains=eng._cdyn.bound_gains, ground_fn=ground,
    )
    for dtype in (torch.float64, torch.float32):
        packed = cd.pack(eng._tau_c, 1e-3, eng._imu_frames, "cpu", dtype)
        ci, cf = packed.ci.numpy(), packed.cf.numpy()
        ti, tf = terrain.pack_ground(ground, dtype=dtype)
        oi, of = ci[cdyn.CI_TERRAIN], ci[cdyn.CI_TERRAIN + 1]
        assert packed.terrain == 1 and flat.terrain == 0
        assert oi == len(flat.ci) and of == len(flat.cf)
        np.testing.assert_array_equal(ci[oi:], ti.numpy())
        np.testing.assert_array_equal(cf[of:], tf.numpy())
        head = np.concatenate([ci[:cdyn.CI_TERRAIN], ci[cdyn.CI_TERRAIN + 2:oi]])
        flat_ci = flat.ci.numpy()
        np.testing.assert_array_equal(
            head, np.concatenate([flat_ci[:cdyn.CI_TERRAIN], flat_ci[cdyn.CI_TERRAIN + 2:]]))
        np.testing.assert_array_equal(cf[:of], flat.cf.numpy().astype(cf.dtype))
        assert list(flat_ci[cdyn.CI_TERRAIN:cdyn.CI_TERRAIN + 2]) == [0, 0]
        assert packed.counts == flat.counts
    # the program: [n_ops, depth, (opcode, float offset, octaves, seed) x 3]
    assert list(ti[:2]) == [3, 2]
    assert list(ti[2::4]) == [terrain.T_PERLIN, terrain.T_STAIRS, terrain.T_SUM]


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
    """Rolling rows, sphere contacts and distance-loop rows build on every
    path and take the kernels' extended body (their radii and rolling
    constraints packed after the loops'); terrain builds, and a ground
    without a packed form is refused for the card (queue 2 item 6)."""
    eng = cm_env.engine
    cd, opts = eng._cdyn_cm, eng._solver_opts
    opts_s = opts
    run = eng._get_period_run("rk4")
    packed = cd.pack(eng._tau_c, run.dt, (), "cpu", torch.float64)
    assert solver.cm_ext(packed, run.pack("cpu", torch.float64)) == 0
    loops = dataclasses.replace(eng.cset, distance_pairs=((89, 123),), distance_ref=(0.5,))
    spheres = dataclasses.replace(eng.cset, contact_radii=(0.02,) * 4)
    for cset, counts in (
        (dataclasses.replace(eng.cset, sphere_specs=((89, 0.02),)), (0, 1, 31)),
        (dataclasses.replace(eng.cset, wheel_specs=((89, 0.02, (0.0, 1.0, 0.0)),)), (0, 1, 31)),
        (loops, (1, 0, 29)),
        (spheres, (0, 0, 28)),
    ):
        pr = solver.ConstrainedPeriodIntegrator(cd, eng._tau_c, cset, opts, 1e-3, 1, "rk4", 12, ())
        assert pr.n_cc == 12 + counts[0] + cset.total_rows + 4 + 12 + counts[1]
        cpk = solver.pack_constraints(cd, cset, opts, "cpu", torch.float64)
        k = cpk.counts
        assert (k["nd_rows"], k["nr_rows"], k["n_rows"]) == counts
        assert solver.cm_ext(packed, cpk) == 1
        radii = cpk.sf[solver.SF_HEADER + opts.iter_max + solver.SF_BOUND * 12
                       + solver.SF_CONTACT * 4 + solver.SF_DISTANCE * counts[0]:][:4]
        assert radii.tolist() == list(cset.contact_radii)
    # Terrain builds in constraint mode; a ground without a packed form runs
    # on the CPU (the plain solve) and is refused for the card and by the
    # kernels' packing (the model's buffers carry the ground's program)
    packed = terrain.random_perlin_ground(1.5, 0.05, seed=3)
    for ground in (packed, _user_ground):
        opts = cm_env.engine.options.replace(world=WorldOptions(ground_profile=ground))
        eng_t = type(eng)(cm_env.robot, opts, device="cpu")
        cd_t = eng_t._cdyn_cm
        assert cd_t.ground_fn is ground
        solver.pack_constraints(cd_t, eng_t.cset, opts_s, "cpu", torch.float64)
        if ground is _user_ground:
            with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2 item 6"):
                engine_mod._refuse_unported(cm_env.robot, opts, torch.device("cuda", 0))
            with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2 item 6"):
                cd_t.pack(eng_t._tau_c, 1e-3, eng_t._imu_frames, "cpu", torch.float64)
        else:
            assert cd_t.pack(eng_t._tau_c, 1e-3, eng_t._imu_frames, "cpu",
                             torch.float64).terrain == 1


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
    frames = sf[off + 48:off + 96].reshape(4, 12)
    np.testing.assert_array_equal(frames[:, :3], model.fplacement_pos[list(cset.contact_frame_indices)])
    np.testing.assert_array_equal(sf[off + 96:], [0.0] * 4)  # the contacts' radii


def test_loop_closure_entry_points_run_on_the_card_and_never_fall_back(monkeypatch):
    """The Cassie/Digit slice: `make` of its ids and an engine of a loop
    robot run on the card unless asked for the CPU; the constrained
    wrappers refuse CPU tensors; the kernels' extended body is chosen for a
    core with loops, spring contacts or penalty bounds beside its rows, and
    not for the constraint-mode ANYmal."""
    from jiminy_torch.engine.engine import Engine
    from jiminy_torch.testing import fourbar_options, fourbar_robot, loop_inputs

    eng = Engine(fourbar_robot(True), fourbar_options(True), device="cpu", dtype=torch.float64)
    q, v, cmd, tail = loop_inputs(eng, [0.4, -0.3, 0.2], 2, seed=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        eng._get_period_run("rk4").kernel(q, v, torch.cat([cmd, tail], -1))
    run = eng._get_rollout_run("zoh-test", cdyn.ZOHPassThrough(1), 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        run.kernel(q, v, torch.cat([cmd, tail[:, :1]], -1), tail[:, 1:])
    assert all(k.launches == 0 for k in cdyn.KERNELS.values())
    pr = eng._get_period_run("rk4")
    packed = eng._cdyn_cm.pack(eng._tau_c, pr.dt, (), "cpu", torch.float64)
    assert solver.cm_ext(packed, pr.pack("cpu", torch.float64)) == 1
    cm = make("anymal-pid", device="cpu", dtype=torch.float64)
    cm = make("anymal-pid", device="cpu", dtype=torch.float64,
              options=constraint_mode_options(cm.engine.options))
    pr = cm.engine._get_period_run("rk4")
    packed = cm.engine._cdyn_cm.pack(cm.engine._tau_c, pr.dt, (), "cpu", torch.float64)
    assert solver.cm_ext(packed, pr.pack("cpu", torch.float64)) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("digit-pid", "cassie"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(fourbar_robot(False), fourbar_options(False))


def test_forest_spring_section_has_two_roots():
    """The ANYmal + acrobot forest of the multi-robot engine: the spring
    kernels' tree (`spring_section`) has two slots at depth 0, the ANYmal's
    FREE root (joint 0) and the acrobot's shoulder, both with parent slot
    -1; the constrained kernels read the same roots from the packed
    parents (-1)."""
    from jiminy_torch.engine.multi import MultiRobotEngine
    from jiminy_torch.testing import forest_robots

    base = make("anymal-pid", device="cpu", dtype=torch.float64).engine.options
    for opts in (base, constraint_mode_options(base)):
        eng = MultiRobotEngine(forest_robots(), opts, device="cpu").engine
        cd = eng._cdyn if eng._cdyn is not None else eng._cdyn_cm
        model = eng.robot.model
        roots = [j for j, p in enumerate(model.parents) if p < 0]
        assert roots == [0, 13] and model.joint_types[0] == 0  # FREE first
        sec = cdyn.spring_section(cd, eng._tau_c)
        nlev, nj = sec[0], model.njoints
        lstart = sec[2:3 + nlev]
        jorder = sec[3 + nlev:3 + nlev + nj]
        pslot = sec[3 + nlev + 2 * nj:3 + nlev + 3 * nj]
        assert lstart[1] - lstart[0] == 2 and jorder[:2] == roots
        assert pslot[:2] == [-1, -1] and all(p >= 0 for p in pslot[2:])
        packed = cd.pack(eng._tau_c, 1e-3, eng._imu_frames, "cpu", torch.float64)
        joints = packed.ci.numpy()[cdyn.CI_HEADER:cdyn.CI_HEADER + cdyn.CI_JOINT * nj]
        assert [int(j) for j in range(nj) if joints[cdyn.CI_JOINT * j] < 0] == roots


def _cm_layout_bytes(nj, nq, nv, n, nc, nb, ns, nd, ncs, nr, n_cmd, n_act, n_blk, elt):
    """`CmLayout(...).bytes` padded by `cm_env_stride` (csrc/pgs.cuh, at
    CM_LANES = 8): one env's slice of the constrained kernels."""
    off = 0

    def take(count, size):
        nonlocal off
        off += (count * size + 15) // 16 * 16

    take(max(72 * nj, n * nv + n * (n + 1) // 2), elt)  # tree passes / W and A
    for count in (n * ns, nv * (nv + 1) // 2, nv, nv, nv, nv, nq, nv, nv, n, n, n, nc, 3 * n):
        take(count, elt)
    for count in (n, n, n, n, 4, nc, nj, nj + 1):
        take(count, 4)
    take(3 * (nc + nb), 1)
    for count in (nd, 6 * ncs, nr, nq, nv, nv, nv, n_cmd, n_act, n_blk):
        take(count, elt)
    words = off // 4
    want = (8 * elt // 4) % 32
    return 4 * (words + (want - words % 32 + 32) % 32)


def test_procedural_cassie_constrained_slice_follows_its_rows(monkeypatch):
    """The procedural Cassie (no continuous joint) takes the constrained
    kernels' extended body: 2 loop rows and nothing else as rows, its 4 toe
    contacts as spring-damper forces and its 10 penalty bounds in the core;
    the slice `cm_smem_per_env` asks the library for is the one those counts
    give (`CmLayout`)."""
    env = make("cassie-pid", device="cpu", dtype=torch.float64, procedural=True)
    eng = env.env.engine
    cset = eng.cset
    assert (cset.total_rows, cset.n_distance, cset.n_contacts, cset.n_bounds) == (2, 2, 0, 0)
    run = eng._get_period_run("rk4")
    asked = []

    class Lib:
        def cm_smem_bytes(self, *args):
            asked.append(args)
            return _cm_layout_bytes(*args)

    monkeypatch.setattr(kernels, "load", lambda *a, **k: Lib())
    for dtype, elt in ((torch.float32, 4), (torch.float64, 8)):
        packed = eng._cdyn_cm.pack(eng._tau_c, run.dt, eng._imu_frames, "cpu", dtype)
        cpk = solver.pack_constraints(eng._cdyn_cm, cset, eng._solver_opts, "cpu", dtype)
        k, c = cpk.counts, packed.counts
        assert (k["n_rows"], k["nd_rows"], k["nc_rows"], k["nb_rows"], k["nr_rows"]) == (
            2, 2, 0, 0, 0)
        assert (c["nc"], c["nb"], c["nm"]) == (4, len(eng._bound_gains), 10) and c["nb"] == 10
        assert solver.cm_ext(packed, cpk) == 1
        smem = solver.cm_smem_per_env(packed, cpk, dtype, run.n_cmd)
        model = eng.robot.model
        want = (model.njoints, model.nq, model.nv, 2, 0, 0, k["support_width"], 2, 4, 0,
                run.n_cmd, 0, 0, elt)
        assert asked[-1] == want and smem == _cm_layout_bytes(*want)
