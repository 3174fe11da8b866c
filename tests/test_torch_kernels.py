"""Card-only tests: each cdyn CUDA kernel held against its plain PyTorch
version on the card, at a small batch, for the ANYmal constants (the
constrained kernels for `anymal-pid` in constraint contact mode, on states
with active contact and bound rows, and for the pendulum: a fixed root, no
contact, one bound row, 50 ticks behind a ZOH controller) and, for the
spring kernels, for the full Atlas (`atlas-pid`); all five for the ANYmal
on rough ground (`testing.rough_ground`), each env at its own (x, y), their
terrain instances evaluating the ground per contact; and the constrained
kernels' extended body (loop closures beside spring-damper contacts and
penalty bounds) for `digit-pid` and jiminy_tpu's Cassie-shaped four-bar
with a foot (`testing.fourbar_robot`), each flat and rough; the constrained
kernels for the Atlas in constraint mode (`atlas-reduced-pid`, 60 rows, and
`atlas-pid`, 78 rows and nv 36) and for the ant with its joint bounds as
rows (44 rows).

Marked `cuda`; they skip where no CUDA device is present (the check runs in a
fixture, never at import). On a machine with a card, run them with:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

(`--noconftest` because the repo's conftest configures JAX, which the port
neither needs nor finds on the card's machine.)

Tolerances, per output column, so that a small output is not hidden
behind a large one:
- float64: max over envs |kernel - plain| / (1 + max over envs |plain|)
  below 1e-9. Both sides run the same IEEE operations; the kernels differ by
  FMA contraction and, in the constrained kernels, by the order of the sums
  that a group of lanes shares.
- float32: the 90th percentile over envs of |kernel - plain| / RMS of the
  column below 2e-3 for one evaluation, 1e-2 for integrated periods and
  steps. FMA contraction changes the last bit of many products, and the
  stiff contact and penalty-bound springs amplify such differences in the
  odd env over a step; a zeroed column, or one wrong in a tenth of the envs,
  still fails.
"""

import dataclasses

import pytest
import torch

from jiminy_torch.engine import solver
from jiminy_torch.envs import make
from jiminy_torch.ops import cdyn
from jiminy_torch.testing import (
    bound_row_inputs,
    column_errors,
    column_quantile_errors,
    constrained_inputs,
    constraint_mode_options,
    ground_options,
    perturbed_states,
    rough_ground,
    spread_on_ground,
)

TOL = {torch.float64: (1e-9, 1e-9), torch.float32: (2e-3, 1e-2)}


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _env(device, dtype):
    return make("anymal-pid", device=device, dtype=dtype)


def _error(out, ref, dtype) -> float:
    fn = column_errors if dtype == torch.float64 else column_quantile_errors
    return float(fn(out, ref).max())


@pytest.mark.cuda
def test_kernel_library_builds(cuda_device):
    from jiminy_torch.ops import kernels

    lib = kernels.load()
    # a small slice takes the most envs a block, a slice past what a block
    # may hold is refused
    assert lib.cm_geometry("cdyn_period_cm", 4, 1024)[0] == 4
    with pytest.raises(RuntimeError, match="no block"):
        lib.cm_geometry("cdyn_rollout_cm", 4, 300_000)
    for name in ("cdyn_accel", "cdyn_period", "cdyn_rollout", "cdyn_period_cm",
                 "cdyn_rollout_cm"):
        assert name in lib.build.ptxas_log


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_accel_kernel_matches_plain(cuda_device, dtype):
    env = _env(cuda_device, dtype)
    cd = env.engine._cdyn
    q, v, tau = perturbed_states(env, 512, seed=0)
    out = cd.accel_kernel(q, v, tau)
    ref = cd.accel_plain(q, v, tau)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _error(out, ref, dtype) < TOL[dtype][0]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [131071, 1])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_accel_kernel_matches_plain_at_ragged_batches(cuda_device, dtype, batch):
    """cdyn_accel with the last block of envs part-filled, on (B, n) rows
    handed in as they are (no copy) and on a broadcast torque row."""
    env = _env(cuda_device, dtype)
    cd = env.engine._cdyn
    q, v, tau = perturbed_states(env, batch, seed=5)
    for t in (tau, tau[0]):
        out = cd.accel_kernel(q, v, t)
        ref = cd.accel_plain(q, v, t)
        torch.cuda.synchronize()
        assert out.shape == (batch, env.robot.nv) and torch.isfinite(out).all()
        assert _error(out, ref, dtype) < TOL[dtype][0]


@pytest.mark.cuda
def test_accel_slice_size_matches_its_layout(cuda_device):
    """The library's cdyn_accel slice is the size tests/test_torch_accel_slice.py
    derives from its layout, smaller than the period kernel's."""
    from test_torch_accel_slice import accel_slice_bytes

    from jiminy_torch.ops import kernels

    c = _env(cuda_device, torch.float32).engine._cdyn.pack(None, 0.0, (), cuda_device,
                                                          torch.float32).counts
    lib = kernels.load()
    for elt in (4, 8):
        per_env, lanes, envs = lib.accel_smem_bytes(c["nj"], c["nq"], c["nv"], c["nc"], elt)
        assert per_env == accel_slice_bytes(c["nj"], c["nq"], c["nv"], c["nc"], elt, lanes)
        assert per_env < lib.sp_smem_bytes(c["nj"], c["nq"], c["nv"], c["nc"], 12, 0, 0, elt)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_period_kernel_matches_plain(cuda_device, dtype):
    env = _env(cuda_device, dtype)
    run = env.engine._get_period_run("rk4")
    q, v, _ = perturbed_states(env, 64, seed=1)
    cmd = torch.randn((64, env.robot.nmotors), dtype=dtype, device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(1)) * 20.0
    outs = run.kernel(q, v, cmd, n_substeps=2)
    refs = run.plain(q, v, cmd, n_substeps=2)
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        assert torch.isfinite(out).all()
        assert _error(out, ref, dtype) < TOL[dtype][1]


@pytest.mark.cuda
@pytest.mark.parametrize("controller", ["pd", "zoh"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rollout_kernel_matches_plain(cuda_device, dtype, controller):
    env = _env(cuda_device, dtype)
    base = env.env
    nm = env.robot.nmotors
    q, v, _ = perturbed_states(env, 64, seed=2)
    gen = torch.Generator(cuda_device).manual_seed(2)
    if controller == "pd":
        ctrl = env.block.component_controller(base)
        action = torch.randn((64, nm), dtype=dtype, device=cuda_device, generator=gen) * 50.0
        carry = torch.zeros((64, 3 * nm), dtype=dtype, device=cuda_device)
        carry[:, :nm] = q[:, 7:]
    else:
        ctrl = cdyn.ZOHPassThrough(nm)
        action = torch.randn((64, nm), dtype=dtype, device=cuda_device, generator=gen) * 20.0
        carry = torch.zeros((64, 0), dtype=dtype, device=cuda_device)
    run = base.engine._get_rollout_run("test-" + controller, ctrl, 8)
    outs = run.kernel(q, v, action, carry, n_ticks=2, n_substeps=1)
    refs = run.plain(q, v, action, carry, n_ticks=2, n_substeps=1)
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        assert torch.isfinite(out).all()
        assert _error(out, ref, dtype) < TOL[dtype][1]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [131071, 1])
@pytest.mark.parametrize("controller", ["pd", "zoh", "period"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_spring_kernels_match_plain_at_ragged_batches(cuda_device, dtype, controller, batch):
    """Batches that leave the last block of envs part-filled (131071 is one
    short of the main path's batch; 1 fills one group of lanes)."""
    env = _env(cuda_device, dtype)
    base = env.env
    nm = env.robot.nmotors
    q, v, _ = perturbed_states(env, batch, seed=3)
    gen = torch.Generator(cuda_device).manual_seed(3)
    action = torch.randn((batch, nm), dtype=dtype, device=cuda_device, generator=gen) * 20.0
    if controller == "period":
        run = base.engine._get_period_run("rk4")
        outs, refs = run.kernel(q, v, action, n_substeps=2), run.plain(q, v, action, n_substeps=2)
    else:
        if controller == "pd":
            ctrl = env.block.component_controller(base)
            carry = torch.zeros((batch, 3 * nm), dtype=dtype, device=cuda_device)
            carry[:, :nm] = q[:, 7:]
        else:
            ctrl = cdyn.ZOHPassThrough(nm)
            carry = torch.zeros((batch, 0), dtype=dtype, device=cuda_device)
        run = base.engine._get_rollout_run("test-" + controller, ctrl, 8)
        outs = run.kernel(q, v, action, carry, n_ticks=2, n_substeps=1)
        refs = run.plain(q, v, action, carry, n_ticks=2, n_substeps=1)
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        assert torch.isfinite(out).all()
        assert _error(out, ref, dtype) < TOL[dtype][1]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["cdyn_period", "cdyn_rollout", "cdyn_accel"])
def test_spring_launch_refuses_what_does_not_fit(cuda_device, kernel, monkeypatch):
    """A launch whose envs would need more shared memory than a block may
    use raises; nothing runs in its place."""
    env = _env(cuda_device, torch.float32)
    nm = env.robot.nmotors
    q, v, tau = perturbed_states(env, 4, seed=4)
    action = torch.zeros((4, nm), dtype=torch.float32, device=cuda_device)
    monkeypatch.setattr(cdyn, "sp_smem_per_env", lambda *args: 200_000)
    monkeypatch.setattr(cdyn, "accel_smem_per_env", lambda *args: 200_000)
    cdyn.reset_launch_counts()
    with pytest.raises(RuntimeError, match=kernel):
        if kernel == "cdyn_accel":
            env.engine._cdyn.accel_kernel(q, v, tau)
        elif kernel == "cdyn_period":
            env.env.engine._get_period_run("rk4").kernel(q, v, action)
        else:
            ctrl = cdyn.ZOHPassThrough(nm)
            run = env.env.engine._get_rollout_run("test-zoh", ctrl, 8)
            run.kernel(q, v, action, torch.zeros((4, 0), device=cuda_device))
    torch.cuda.synchronize()
    assert cdyn.KERNELS[kernel].launches == 0


def _atlas_pid(device, friction=False):
    """atlas-pid at float64; with `friction`, every motor's declared viscous
    friction (-0.1 / -0.2 N m s/rad, not enabled in its hardware file) on."""
    from jiminy_torch.envs import assets

    if not friction:
        return make("atlas-pid", device=device, dtype=torch.float64)
    load = assets.load_hardware_description_file

    def with_friction(path):
        hw = load(path)
        for m in hw["motors"]:
            m["enable_friction"] = True
        return hw

    assets.load_hardware_description_file = with_friction
    try:
        return make("atlas-pid", device=device, dtype=torch.float64)
    finally:
        assets.load_hardware_description_file = load


@pytest.mark.cuda
@pytest.mark.parametrize("friction", [False, True], ids=["atlas", "atlas-friction"])
@pytest.mark.parametrize("batch", [2048, 2047, 1])
@pytest.mark.parametrize("kernel", ["cdyn_accel", "cdyn_period", "cdyn_rollout"])
def test_atlas_spring_kernels_match_plain(cuda_device, kernel, batch, friction):
    """atlas-pid at float64 (31 joints, depths wider than an env's 4 lanes,
    12 contacts, 6 a force-sensor frame, 30 motors at the velocity-effort
    envelope, a 90-value PD carry), on perturbed states, at full and ragged
    batches: beyond the constrained kernels' caps, held only to its shared
    memory slice."""
    env = _atlas_pid(cuda_device, friction)
    eng = env.env.engine
    nm = env.robot.nmotors
    assert nm == 30 and env.robot.nv == 36
    if friction:
        assert all(eng._build_tau_c().friction)
    q, v, tau = perturbed_states(env, batch, seed=5)
    gen = torch.Generator(cuda_device).manual_seed(5)
    action = torch.randn((batch, nm), dtype=torch.float64, device=cuda_device, generator=gen) * 50.0
    cdyn.reset_launch_counts()
    if kernel == "cdyn_accel":
        outs, refs = (eng._cdyn.accel_kernel(q, v, tau),), (eng._cdyn.accel_plain(q, v, tau),)
    elif kernel == "cdyn_period":
        run = eng._get_period_run("rk4")
        outs, refs = run.kernel(q, v, action, n_substeps=2), run.plain(q, v, action, n_substeps=2)
    else:
        ctrl = env.block.component_controller(env.env)
        carry = torch.zeros((batch, 3 * nm), dtype=torch.float64, device=cuda_device)
        carry[:, :nm] = q[:, 7:]
        run = eng._get_rollout_run("test-atlas", ctrl, env.env.n_ctrl_per_step)
        outs = run.kernel(q, v, action, carry, n_ticks=2, n_substeps=2)
        refs = run.plain(q, v, action, carry, n_ticks=2, n_substeps=2)
    torch.cuda.synchronize()
    assert cdyn.KERNELS[kernel].launches == 1
    tol = TOL[torch.float64][kernel != "cdyn_accel"]
    for out, ref in zip(outs, refs):
        assert torch.isfinite(out).all()
        assert _error(out, ref, torch.float64) < tol
        assert _error(torch.zeros_like(out), ref, torch.float64) > tol or not ref.any()


@pytest.mark.cuda
def test_atlas_steps_through_the_spring_kernels(cuda_device):
    """make("atlas-pid") resets and steps on the card through cdyn_accel,
    cdyn_rollout and, per period, cdyn_period, with no caps refusal."""
    env = make("atlas-pid", device=cuda_device)
    action = torch.zeros(env.action_size, device=cuda_device)
    cdyn.reset_launch_counts()
    st, _ = env.reset(batch_size=5)
    st, *_ = env.step(st, action)
    env.use_fused_rollout = False
    st, *_ = env.step(st, action)
    torch.cuda.synchronize()
    assert cdyn.KERNELS["cdyn_accel"].launches == 1
    assert cdyn.KERNELS["cdyn_rollout"].launches == 1
    assert cdyn.KERNELS["cdyn_period"].launches == env.env.n_ctrl_per_step == 16
    assert torch.isfinite(st.sim.q).all() and st.sim.q.shape == (5, 37)


@pytest.mark.cuda
def test_wrappers_route_cuda_tensors_to_kernels(cuda_device):
    env = _env(cuda_device, torch.float64)
    cdyn.reset_launch_counts()
    st, _ = env.reset(batch_size=3)
    st, *_ = env.step(st, torch.zeros(12, dtype=torch.float64, device=cuda_device))
    torch.cuda.synchronize()
    assert cdyn.KERNELS["cdyn_accel"].launches == 1
    assert cdyn.KERNELS["cdyn_rollout"].launches == 1
    assert torch.isfinite(st.sim.q).all()


@pytest.mark.cuda
def test_dopri_steps_through_cdyn_accel(cuda_device):
    """Adaptive DOPRI on the card: every dynamics evaluation of a period is
    one cdyn_accel launch over the batch, 2 + 6 x the period's trials (the
    most any env took); at float64 the period matches the plain path on the
    CPU, trial for trial."""
    from jiminy_torch.testing import dopri_options

    def engine(device):
        base = _env(device, torch.float64).engine.options
        return make("anymal-pid", device=device, dtype=torch.float64,
                    options=dopri_options(base)).engine

    eng, eng_cpu = engine(cuda_device), engine("cpu")
    env_cpu = make("anymal-pid", device="cpu", dtype=torch.float64)
    q, v, _ = perturbed_states(env_cpu, 6, seed=6)
    cmd = torch.zeros((6, 12), dtype=torch.float64)
    st_cpu = eng_cpu.step(eng_cpu.reset(q, v * 0.1), cmd)
    st = eng.reset(q.to(cuda_device), (v * 0.1).to(cuda_device))
    cdyn.reset_launch_counts()
    st = eng.step(st, cmd.to(cuda_device))
    torch.cuda.synchronize()
    trials = (st.stepper.iterations + st.stepper.iter_failed).cpu()
    assert torch.equal(trials, st_cpu.stepper.iterations + st_cpu.stepper.iter_failed)
    assert cdyn.KERNELS["cdyn_accel"].launches == 2 + 6 * int(trials.max())
    assert sum(k.launches for k in cdyn.KERNELS.values()) == cdyn.KERNELS["cdyn_accel"].launches
    for a, b in ((st.q, st_cpu.q), (st.v, st_cpu.v), (st.a, st_cpu.a)):
        assert float(column_errors(a.cpu(), b).max()) < 1e-9


def _cm_env(device, dtype):
    env = _env(device, dtype)
    return make("anymal-pid", device=device, dtype=dtype,
                options=constraint_mode_options(env.engine.options))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_constrained_period_kernel_matches_plain(cuda_device, dtype):
    env = _cm_env(cuda_device, dtype)
    run = env.engine._get_period_run("rk4")
    q, v, cmd, sol = constrained_inputs(env, 64, seed=3)
    cc = torch.cat([cmd, sol], dim=-1)
    outs = run.kernel(q, v, cc, n_substeps=2)
    refs = run.plain(q, v, cc, n_substeps=2)
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        assert torch.isfinite(out).all()
        assert _error(out, ref, dtype) < TOL[dtype][1]


@pytest.mark.cuda
@pytest.mark.parametrize("controller", ["pd", "zoh"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_constrained_rollout_kernel_matches_plain(cuda_device, dtype, controller):
    env = _cm_env(cuda_device, dtype)
    nm = env.robot.nmotors
    q, v, cmd, sol = constrained_inputs(env, 64, seed=4)
    if controller == "pd":
        ctrl = env.block.component_controller(env.env)
        block = torch.zeros((64, 3 * nm), dtype=dtype, device=cuda_device)
        block[:, :nm] = q[:, 7:]
        action = cmd * 2.5
    else:
        ctrl = cdyn.ZOHPassThrough(nm)
        block = torch.zeros((64, 0), dtype=dtype, device=cuda_device)
        action = cmd
    carry = torch.cat([block, sol], dim=-1)
    run = env.engine._get_rollout_run("test-" + controller, ctrl, 8)
    outs = run.kernel(q, v, action, carry, n_ticks=2, n_substeps=1)
    refs = run.plain(q, v, action, carry, n_ticks=2, n_substeps=1)
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        assert torch.isfinite(out).all()
        assert _error(out, ref, dtype) < TOL[dtype][1]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,batch", [("all", 64), ("none", 64), ("mixed", 1003), ("mixed", 1)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_constrained_kernels_match_plain_at_the_extremes(cuda_device, dtype, rows, batch):
    """Every row active, none active, and batches that leave the last block
    of envs part-filled."""
    env = _cm_env(cuda_device, dtype)
    nm, n_rows = env.robot.nmotors, env.engine.cset.total_rows
    q, v, cmd, sol = constrained_inputs(env, batch, seed=5, rows=rows)
    if rows != "mixed":
        assert bool((sol[:, n_rows:] == (1.0 if rows == "all" else 0.0)).all())
    run = env.engine._get_period_run("rk4")
    cc = torch.cat([cmd, sol], dim=-1)
    period = run.kernel(q, v, cc, n_substeps=1), run.plain(q, v, cc, n_substeps=1)
    block = torch.zeros((batch, 3 * nm), dtype=dtype, device=cuda_device)
    block[:, :nm] = q[:, 7:]
    carry = torch.cat([block, sol], dim=-1)
    rrun = env.engine._get_rollout_run("test-pd", env.block.component_controller(env.env), 8)
    rollout = (rrun.kernel(q, v, cmd * 2.5, carry, n_ticks=2, n_substeps=1),
               rrun.plain(q, v, cmd * 2.5, carry, n_ticks=2, n_substeps=1))
    torch.cuda.synchronize()
    for outs, refs in (period, rollout):
        for out, ref in zip(outs, refs):
            assert torch.isfinite(out).all()
            assert _error(out, ref, dtype) < TOL[dtype][1]
    lam = period[0][2][:, -sol.shape[1]:][:, :n_rows]  # the solver channels end the extras
    if rows == "none":
        assert bool((lam == 0).all())
    if rows == "all":
        assert bool((lam != 0).any(-1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("too_big", ["rows", "shared memory"])
def test_constrained_launch_refuses_what_does_not_fit(cuda_device, too_big):
    """A model whose envs would need more shared memory than a block may
    use, by its rows or by its supports, raises; nothing runs in its
    place."""
    env = _cm_env(cuda_device, torch.float32)
    run = env.engine._get_period_run("rk4")
    q, v, cmd, sol = constrained_inputs(env, 4, seed=6)
    packed = run.cd.pack(run.tau_c, run.dt, run.imu_frames, cuda_device, torch.float32)
    cpk = run.pack(cuda_device, torch.float32)
    grown = {"rows": dict(n_rows=400), "shared memory": dict(support_width=4000)}[too_big]
    cpk = dataclasses.replace(cpk, counts=dict(cpk.counts, **grown))
    cdyn.reset_launch_counts()
    with pytest.raises((ValueError, RuntimeError), match="constrained kernels|cdyn_period_cm"):
        solver._launch_period_cm(packed, cpk, q, v, torch.cat([cmd, sol], dim=-1), 1,
                                 cdyn._INTEGRATORS["rk4"], run.n_cmd, run.n_extra)
    torch.cuda.synchronize()
    assert cdyn.KERNELS["cdyn_period_cm"].launches == 0


@pytest.mark.cuda
def test_constrained_wrappers_route_cuda_tensors_to_kernels(cuda_device):
    env = _cm_env(cuda_device, torch.float64)
    cdyn.reset_launch_counts()
    st, _ = env.reset(batch_size=3)
    st, *_ = env.step(st, torch.zeros(12, dtype=torch.float64, device=cuda_device))
    env.use_fused_rollout = False
    st, *_ = env.step(st, torch.zeros(12, dtype=torch.float64, device=cuda_device))
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    assert launches == {"cdyn_accel": 0, "cdyn_period": 0, "cdyn_rollout": 0,
                        "cdyn_period_cm": 8, "cdyn_rollout_cm": 1}
    assert torch.isfinite(st.sim.q).all()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,batch", [("mixed", 1003), ("all", 64), ("none", 64), ("mixed", 1)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pendulum_constrained_kernels_match_plain(cuda_device, dtype, rows, batch):
    """The pendulum's model class (fixed root, 0 contacts, 1 bound row) through
    both constrained kernels at the env's own counts: a period of 1 substep
    and a rollout of 50 ticks behind the ZOH controller."""
    env = make("pendulum", device=cuda_device, dtype=dtype)
    eng = env.engine
    assert eng._cdyn_cm is not None and eng.cset.n_contacts == 0 and eng.cset.n_bounds == 1
    q, v, cmd, sol = bound_row_inputs(env, batch, seed=7, rows=rows)
    run = eng._get_period_run("rk4")
    rrun = eng._get_rollout_run("zoh", cdyn.ZOHPassThrough(1), env.n_ctrl_per_step)
    cc = torch.cat([cmd, sol], dim=-1)
    period = run.kernel(q, v, cc), run.plain(q, v, cc)
    rollout = rrun.kernel(q, v, cmd, sol), rrun.plain(q, v, cmd, sol)
    torch.cuda.synchronize()
    for outs, refs in (period, rollout):
        for out, ref in zip(outs, refs):
            assert torch.isfinite(out).all()
            assert _error(out, ref, dtype) < TOL[dtype][1]
    # extras: [a | lam | bound active], then the rollout's command and carry
    for extras in (period[0][2], rollout[0][2]):
        lam, active = extras[:, 1], extras[:, 2]
        if rows == "none":  # inside the +-100 rad bounds: the row never activates
            assert bool((lam == 0).all()) and bool((active == 0).all())
    if rows == "all":  # past the bound: the row is active, and pushes back in some envs
        lam, active = period[0][2][:, 1], period[0][2][:, 2]
        assert bool((active == 1).all()) and bool((lam > 0).any())


@pytest.mark.cuda
def test_pendulum_steps_through_the_constrained_kernels(cuda_device):
    env = make("pendulum", device=cuda_device, dtype=torch.float64)
    cdyn.reset_launch_counts()
    st, _ = env.reset(batch_size=3, generator=torch.Generator(cuda_device).manual_seed(0))
    st, *_ = env.step(st, torch.zeros(1, dtype=torch.float64, device=cuda_device))
    env.use_fused_rollout = False
    st, *_ = env.step(st, torch.zeros(1, dtype=torch.float64, device=cuda_device))
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    assert launches == {"cdyn_accel": 0, "cdyn_period": 0, "cdyn_rollout": 0,
                        "cdyn_period_cm": env.n_ctrl_per_step, "cdyn_rollout_cm": 1}
    assert torch.isfinite(st.sim.q).all()


# --------------------------------------------------------------------------- #
# Terrain: the five kernels' terrain instances on rough ground
# --------------------------------------------------------------------------- #


def _rough_env(device, dtype, constraint=False):
    env = _env(device, dtype)
    opts = ground_options(env.engine.options, rough_ground())
    if constraint:
        opts = constraint_mode_options(opts)
    return make("anymal-pid", device=device, dtype=dtype, options=opts)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["cdyn_accel", "cdyn_period", "cdyn_rollout",
                                    "cdyn_period_cm", "cdyn_rollout_cm"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_terrain_kernels_match_plain(cuda_device, dtype, kernel):
    cm = kernel.endswith("_cm")
    env = _rough_env(cuda_device, dtype, constraint=cm)
    eng, ground = env.engine, env.engine.ground_fn
    nm = env.robot.nmotors
    cdyn.reset_launch_counts()
    if cm:
        q, v, cmd, sol = constrained_inputs(env, 256, seed=7)
    else:
        q, v, tau = perturbed_states(env, 512, seed=7)
        cmd = torch.randn((512, nm), dtype=dtype, device=cuda_device,
                          generator=torch.Generator(cuda_device).manual_seed(7)) * 20.0
    q = spread_on_ground(q, ground, seed=7)
    if kernel == "cdyn_accel":
        outs, refs = (eng._cdyn.accel_kernel(q, v, tau),), (eng._cdyn.accel_plain(q, v, tau),)
    elif kernel == "cdyn_period":
        run = eng._get_period_run("rk4")
        outs, refs = run.kernel(q, v, cmd, n_substeps=2), run.plain(q, v, cmd, n_substeps=2)
    elif kernel == "cdyn_period_cm":
        run = eng._get_period_run("rk4")
        cc = torch.cat([cmd, sol], dim=-1)
        outs, refs = run.kernel(q, v, cc, n_substeps=1), run.plain(q, v, cc, n_substeps=1)
    else:
        ctrl = env.block.component_controller(env.env)
        block = torch.zeros((q.shape[0], 3 * nm), dtype=dtype, device=cuda_device)
        block[:, :nm] = q[:, 7:]
        carry = torch.cat([block, sol], dim=-1) if cm else block
        run = eng._get_rollout_run("test-terrain", ctrl, 8)
        outs = run.kernel(q, v, cmd * 2.5, carry, n_ticks=2, n_substeps=1)
        refs = run.plain(q, v, cmd * 2.5, carry, n_ticks=2, n_substeps=1)
    torch.cuda.synchronize()
    assert cdyn.KERNELS[kernel].launches == 1
    for out, ref in zip(outs, refs):
        assert torch.isfinite(out).all()
        assert _error(out, ref, dtype) < TOL[dtype][1]


@pytest.mark.cuda
def test_flat_kernel_misses_the_terrain(cuda_device):
    """The witness: the flat instance on the same states disagrees with the
    terrain's plain version, and the terrain's normals are off vertical."""
    env = _rough_env(cuda_device, torch.float64)
    cd = env.engine._cdyn
    q, v, tau = perturbed_states(env, 512, seed=8)
    q = spread_on_ground(q, cd.ground_fn, seed=8)
    flat = cdyn.ComponentDynamics(env.robot.model, cd.gravity, contact_opts=cd.contact_opts,
                                  contact_frames=cd.contact_frames, bound_gains=cd.bound_gains)
    ref = cd.accel_plain(q, v, tau)
    assert _error(cd.accel_kernel(q, v, tau), ref, torch.float64) < TOL[torch.float64][0]
    assert _error(flat.accel_kernel(q, v, tau), ref, torch.float64) > 1e-3



# --------------------------------------------------------------------------- #
# Loop closures beside spring-damper contacts and penalty bounds: the
# constrained kernels' extended body
# --------------------------------------------------------------------------- #


def _loop_engine(device, dtype, model, ground):
    from jiminy_torch.engine.engine import Engine
    from jiminy_torch.testing import fourbar_options, fourbar_robot

    if model == "fourbar_c":
        opts = fourbar_options(True)
        if ground == "rough":
            opts = ground_options(opts, rough_ground())
        return Engine(fourbar_robot(True), opts, device=device, dtype=dtype), None
    env = make("digit-pid", device=device, dtype=dtype)
    if ground == "rough":
        env = make("digit-pid", device=device, dtype=dtype,
                   options=ground_options(env.engine.options, rough_ground()))
    return env.engine, env


@pytest.mark.cuda
@pytest.mark.parametrize("model,ground", [("digit", "flat"), ("digit", "rough"),
                                          ("fourbar_c", "flat"), ("fourbar_c", "rough")])
@pytest.mark.parametrize("kernel", ["cdyn_period_cm", "cdyn_rollout_cm"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_loop_kernels_match_plain(cuda_device, dtype, kernel, model, ground):
    from jiminy_torch.testing import loop_inputs

    eng, env = _loop_engine(cuda_device, dtype, model, ground)
    q0 = env.env.nominal_q.cpu().numpy() if env is not None else [0.4, -0.3, 0.2]
    q, v, cmd, tail = loop_inputs(eng, q0, 64, seed=5)
    nd = eng.cset.n_distance
    if kernel == "cdyn_period_cm":
        run = eng._get_period_run("rk4")
        cc = torch.cat([cmd, tail], dim=-1)
        outs = run.kernel(q, v, cc, n_substeps=2)
        refs = run.plain(q, v, cc, n_substeps=2)
    else:
        nm = eng.robot.nmotors
        if env is not None:
            ctrl = env.block.component_controller(env.env)
            block = torch.cat([q[:, 7:], torch.zeros((64, 2 * nm), dtype=dtype,
                                                     device=cuda_device)], dim=-1)
        else:
            ctrl = cdyn.ZOHPassThrough(nm)
            block = torch.zeros((64, 0), dtype=dtype, device=cuda_device)
        run = eng._get_rollout_run("test", ctrl, 16)
        action = torch.cat([cmd * 0.01, tail[:, :nd]], dim=-1)
        carry = torch.cat([block, tail[:, nd:]], dim=-1)
        outs = run.kernel(q, v, action, carry, n_ticks=2, n_substeps=1)
        refs = run.plain(q, v, action, carry, n_ticks=2, n_substeps=1)
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        assert torch.isfinite(out).all()
        assert _error(out, ref, dtype) < TOL[dtype][1]


@pytest.mark.cuda
def test_digit_steps_through_cdyn_rollout_cm(cuda_device):
    env = make("digit-pid", device=cuda_device, dtype=torch.float32)
    st, _ = env.reset(batch_size=256)
    cdyn.reset_launch_counts()
    st, *_ = env.step(st, torch.zeros(env.action_size, device=cuda_device))
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    assert launches == {"cdyn_accel": 0, "cdyn_period": 0, "cdyn_rollout": 0,
                        "cdyn_period_cm": 0, "cdyn_rollout_cm": 1}
    assert torch.isfinite(st.sim.q).all() and st.sim.distance_ref.shape == (256, 2)


def _atlas_cm(device, dtype, name):
    base = make(name, device=device, dtype=dtype).engine.options
    return make(name, device=device, dtype=dtype, options=constraint_mode_options(base))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rows,batch", [
    (torch.float64, "mixed", 67), (torch.float64, "all", 16), (torch.float64, "none", 16),
    (torch.float64, "mixed", 1), (torch.float32, "mixed", 67), (torch.float32, "all", 16),
    (torch.float32, "none", 16)])
@pytest.mark.parametrize("name", ["atlas-reduced-pid", "atlas-pid"])
def test_atlas_constrained_kernels_match_plain(cuda_device, dtype, name, rows, batch):
    """The Atlas in constraint mode (60 and 78 rows, nv 18 and 36, the rows
    past the sweep's registers in the slice): a period of one substep and a
    rollout of 2 ticks of one substep behind the PD block, every row, no
    row and some rows active, batches that leave the last block part-filled.
    Float32 over batches only: its measure is the 90th percentile over envs,
    and the stiff bound and contact rows carry a one-ulp difference of a
    single env past TOL's 1e-2 of the column's RMS (measured 0.34 at B = 1)."""
    env = _atlas_cm(cuda_device, dtype, name)
    nm, n_rows = env.robot.nmotors, env.engine.cset.total_rows
    assert n_rows == {"atlas-reduced-pid": 60, "atlas-pid": 78}[name]
    q, v, cmd, sol = constrained_inputs(env, batch, seed=7, rows=rows)
    run = env.engine._get_period_run("rk4")
    cc = torch.cat([cmd, sol], dim=-1)
    period = run.kernel(q, v, cc, n_substeps=1), run.plain(q, v, cc, n_substeps=1)
    block = torch.zeros((batch, 3 * nm), dtype=dtype, device=cuda_device)
    block[:, :nm] = q[:, 7:]
    carry = torch.cat([block, sol], dim=-1)
    rrun = env.engine._get_rollout_run("test-pd", env.block.component_controller(env.env), 16)
    rollout = (rrun.kernel(q, v, cmd * 2.5, carry, n_ticks=2, n_substeps=1),
               rrun.plain(q, v, cmd * 2.5, carry, n_ticks=2, n_substeps=1))
    torch.cuda.synchronize()
    for outs, refs in (period, rollout):
        for out, ref in zip(outs, refs):
            assert torch.isfinite(out).all()
            assert _error(out, ref, dtype) < TOL[dtype][1]
    channels = period[0][2][:, -sol.shape[1]:]  # [lam | contact active | bound active]
    lam, nc = channels[:, :n_rows], env.engine.cset.n_contacts
    active = 4 * channels[:, n_rows:n_rows + nc].sum(-1) + channels[:, n_rows + nc:].sum(-1)
    if rows == "none":
        assert bool((lam == 0).all())
    if rows == "all":  # rows past the registers' in the system
        assert int(active.min()) > 40 and bool((lam != 0).any(-1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ant_bounds_as_rows_kernels_match_plain(cuda_device, dtype):
    """The ant with its joint bounds as rows: 36 sphere rows and 8 bound
    rows through the extended body."""
    from jiminy_torch.engine.config import ContactModel

    opts = make("ant", device=cuda_device, dtype=dtype,
                contact_model=ContactModel.CONSTRAINT).engine.options
    env = make("ant", device=cuda_device, dtype=dtype,
               options=opts.replace(joint_bounds_mode="constraint"))
    assert env.engine.cset.total_rows == 44
    q, v, cmd, sol = constrained_inputs(env, 129, seed=8)
    run = env.engine._get_period_run("rk4")
    cc = torch.cat([cmd, sol], dim=-1)
    rrun = env.engine._get_rollout_run("test-zoh", cdyn.ZOHPassThrough(env.robot.nmotors), 10)
    for outs, refs in ((run.kernel(q, v, cc, n_substeps=2), run.plain(q, v, cc, n_substeps=2)),
                       (rrun.kernel(q, v, cmd * 0.05, sol, n_ticks=2, n_substeps=1),
                        rrun.plain(q, v, cmd * 0.05, sol, n_ticks=2, n_substeps=1))):
        torch.cuda.synchronize()
        for out, ref in zip(outs, refs):
            assert torch.isfinite(out).all()
            assert _error(out, ref, dtype) < TOL[dtype][1]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["atlas-reduced-pid", "atlas-pid"])
def test_atlas_steps_through_the_constrained_kernels(cuda_device, name):
    """make(...) in constraint mode: one cdyn_rollout_cm launch an env step,
    one cdyn_period_cm a controller period on the per-period path."""
    env = _atlas_cm(cuda_device, torch.float32, name)
    st, _ = env.reset(batch_size=64)
    action = torch.zeros(env.action_size, device=cuda_device)
    cdyn.reset_launch_counts()
    st, *_ = env.step(st, action)
    env.use_fused_rollout = False
    st, *_ = env.step(st, action)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    assert launches == {"cdyn_accel": 0, "cdyn_period": 0, "cdyn_rollout": 0,
                        "cdyn_period_cm": env.n_ctrl_per_step, "cdyn_rollout_cm": 1}
    assert torch.isfinite(st.sim.q).all() and torch.isfinite(st.sim.lam).all()
