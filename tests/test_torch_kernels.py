"""Card-only tests: each cdyn CUDA kernel held against its plain PyTorch
version on the card, at a small batch, for the ANYmal constants (the
constrained kernels for `anymal-pid` in constraint contact mode, on states
with active contact and bound rows).

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
    column_errors,
    column_quantile_errors,
    constrained_inputs,
    constraint_mode_options,
    perturbed_states,
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
    assert lib.caps["nj"] >= 13
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
    """A model with more rows than the kernels take, or whose envs would
    need more shared memory than a block may use, raises; nothing runs in
    its place."""
    env = _cm_env(cuda_device, torch.float32)
    run = env.engine._get_period_run("rk4")
    q, v, cmd, sol = constrained_inputs(env, 4, seed=6)
    packed = run.cd.pack(run.tau_c, run.dt, run.imu_frames, cuda_device, torch.float32)
    cpk = run.pack(cuda_device, torch.float32)
    grown = {"rows": dict(n_rows=41), "shared memory": dict(support_width=4000)}[too_big]
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
