#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (jiminy_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Device: the card from nvidia-smi and torch; no CUDA device -> exit 2.
2. Build: nvcc builds csrc/cdyn.cu for sm_90a; the -Xptxas -v summary.
3. Kernels against their plain PyTorch versions on the card, for the ANYmal
   constants, on perturbed states: cdyn_accel at B=4096, cdyn_period and
   cdyn_rollout (PD and zero-order-hold controllers) at B=64 with fewer ticks
   and substeps than an env step. Every output column is held to its own
   scale (TOL): at float64 the largest error over envs, at float32 the 90th
   percentile over envs relative to the column's RMS.
4. Main path: make("anymal-pid") on the card at float32, batched reset at
   B=131072 and 25 steps with zero actions (bench.py's shape), launch counts
   set to 0 just before and read just after; then the per-period path
   (use_fused_rollout=False). Golden rows of tests/goldens/anymal-pid.csv are
   reproduced at float64, B=1, through the kernels on both paths.
5. Kernels at the main path's shapes (B=131072): float32 on the main path's
   own states, timed (CUDA events) beside its plain version; float64 on the
   same states, every column within 1e-9 in every env; float64 and float32
   on perturbed states (not at equilibrium), as in phase 3 (the whole 8-tick
   rollout is let stray beyond 1e-9 in at most F64_CHAOS_SHARE of the envs,
   with a last-bit nudge of the input as the witness of how far rounding
   alone carries them). The bound is max(bytes / 3.35 TB/s, ops / 67
   TFLOP/s) from this run's shapes and an op count of the plain version (one
   torch elementwise call per op, counted on the CPU with a
   TorchFunctionMode) with the model's structural zeros folded away; the
   generic formulation's count, zeros included, is printed beside it.

The last two lines are the `{"kernels": [...]}` record and the device line.
"""

import json
import os
import subprocess
import sys
import time

B_MAIN = 131072
N_STEPS = 25
PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# (one evaluation, integrated period or step), per output column:
# float64 -> max over envs |kernel - plain| / (1 + max over envs |plain|);
# float32 -> 90th percentile over envs of |kernel - plain| / RMS of the column
TOL = {"float64": (1e-9, 1e-9), "float32": (2e-3, 1e-2)}
ERR_NAME = {"float64": "column max rel err", "float32": "column q90 err / rms"}
F64_CHAOS_SHARE = 0.01
GOLDEN_ATOL = 1e-9
ROOT = os.path.dirname(os.path.abspath(__file__))


class Failure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failure(msg)


def log(*args):
    print(*args, flush=True)


def abs_err(outs, refs):
    return max(float((o.double() - r.double()).abs().max()) for o, r in zip(outs, refs))


def output_error(outs, refs, dtype_name):
    """The worst output column's error under TOL's measure for `dtype_name`,
    and where it is."""
    from jiminy_torch.testing import column_errors, column_quantile_errors

    fn = column_errors if dtype_name == "float64" else column_quantile_errors
    labels = ("q'", "v'", "extras") if len(outs) == 3 else ("a",)
    worst, where = -1.0, ""
    for label, o, r in zip(labels, outs, refs):
        e = fn(o, r)
        c = int(e.argmax())
        if float(e[c]) > worst:
            worst, where = float(e[c]), f"{label}[{c}]"
    return worst, where


def share_beyond(outs, refs, tol):
    """Share of envs in which some output column differs by more than
    tol x (1 + max over envs of |ref| in that column)."""
    bad = None
    for o, r in zip(outs, refs):
        o, r = o.double().reshape(-1, o.shape[-1]), r.double().reshape(-1, r.shape[-1])
        b = ((o - r).abs() > tol * (1.0 + r.abs().amax(0))).any(1)
        bad = b if bad is None else bad | b
    return float(bad.double().mean())


def _commands(b, nm, dtype, device, seed, scale=20.0):
    """Random motor commands (or actions) drawn in float64, so every dtype
    gets the same values."""
    import torch

    gen = torch.Generator(device).manual_seed(seed)
    return (torch.randn((b, nm), dtype=torch.float64, device=device, generator=gen)
            * scale).to(dtype)


def nvidia_smi_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# Op counting of the plain versions (one torch elementwise call = one op per env)
# --------------------------------------------------------------------------- #

_COUNTED = {
    "add", "sub", "mul", "div", "neg", "lt", "le", "gt", "ge", "bitwise_or", "bitwise_and",
    "pow", "__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__", "__truediv__",
    "__rtruediv__", "__neg__", "__lt__", "__le__", "__gt__", "__ge__", "__or__", "__and__",
    "__abs__", "__pow__", "where", "clamp", "clamp_min", "clamp_max", "sqrt", "cos", "sin",
    "tanh", "floor", "abs", "minimum", "maximum",
}


def _is_zero(x):
    return (isinstance(x, (int, float)) and x == 0) or getattr(x, "_structural_zero", False)


def _is_one(x):
    return isinstance(x, (int, float)) and x == 1


def _trivial(name, args):
    """(skip, result_is_zero) for an op whose operands include a structural
    zero (a model constant equal to 0, or a tensor computed only from such)
    or a multiplicative one: the work a kernel specialised to the model's
    constants would not do."""
    name = name.strip("_")
    a = args[0] if args else None
    b = args[1] if len(args) > 1 else None
    if name in ("mul", "rmul"):
        if _is_zero(a) or _is_zero(b):
            return True, True
        return _is_one(a) or _is_one(b), False
    if name in ("add", "radd"):
        if _is_zero(a) or _is_zero(b):
            return True, _is_zero(a) and _is_zero(b)
        return False, False
    if name in ("sub", "rsub"):
        minuend, subtrahend = (a, b) if name == "sub" else (b, a)
        return _is_zero(subtrahend), _is_zero(subtrahend) and _is_zero(minuend)
    if name in ("div", "truediv", "rtruediv"):
        num, den = (a, b) if name != "rtruediv" else (b, a)
        if _is_zero(num):
            return True, True
        return _is_one(den), False
    if name in ("neg", "abs"):
        return _is_zero(a), _is_zero(a)
    if name == "where" and len(args) == 3:
        both = _is_zero(args[1]) and _is_zero(args[2])
        return both, both
    return False, False


def count_ops(fn, prune_zeros=False):
    """Elementwise torch calls made by `fn`; with `prune_zeros`, calls that
    only multiply by, add or select structural zeros (or multiply by one)
    are not counted, and their zero results propagate."""
    import torch
    from torch.overrides import TorchFunctionMode

    class Counter(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            out = func(*args, **(kwargs or {}))
            if name not in _COUNTED:
                return out
            if prune_zeros:
                skip, zero = _trivial(name, args)
                if skip:
                    if zero and isinstance(out, torch.Tensor):
                        out._structural_zero = True
                    return out
            Counter.n += 1
            return out

    with torch.no_grad(), Counter():
        fn()
    return Counter.n


def plain_op_counts(env_cpu, prune_zeros):
    """Ops per env of one accel evaluation, one 5-substep period and one
    8-tick rollout, counted on the CPU at B=1 (the rollout from three short
    runs: ops = final + ticks * (controller + substeps * substep)). Without
    `prune_zeros` this is the generic formulation that the kernels run (the
    model's constants read at run time, zeros included); with it, the work
    left once the model's structural zeros are folded away."""
    import torch

    from jiminy_torch.testing import perturbed_states

    eng = env_cpu.env.engine
    q, v, tau = perturbed_states(env_cpu, 1, seed=9)
    nm = env_cpu.robot.nmotors
    cmd = torch.zeros((1, nm), dtype=q.dtype)

    def count(fn):
        return count_ops(fn, prune_zeros)

    accel = count(lambda: eng._cdyn.accel_plain(q, v, tau))
    period_run = eng._get_period_run("rk4")
    period = count(lambda: period_run.plain(q, v, cmd))
    ctrl = env_cpu.block.component_controller(env_cpu.env)
    run = eng._get_rollout_run("count", ctrl, env_cpu.env.n_ctrl_per_step)
    carry = torch.zeros((1, 3 * nm), dtype=q.dtype)

    def n(ticks, subs):
        return count(lambda: run.plain(q, v, cmd, carry, n_ticks=ticks, n_substeps=subs))

    n11, n21, n12 = n(1, 1), n(2, 1), n(1, 2)
    sub = n12 - n11
    ctl = n21 - n11 - sub
    fin = n11 - ctl - sub
    rollout = fin + run.n_ticks * (ctl + run.n_substeps * sub)
    aux = count(lambda: eng._cdyn.aux_outputs(q, v, tau, imu_frames=eng._imu_frames))
    return {"cdyn_accel": accel, "cdyn_period": period, "cdyn_rollout": rollout,
            "aux_outputs (plain torch at reset)": aux}


# --------------------------------------------------------------------------- #
# Phases
# --------------------------------------------------------------------------- #


def phase_build():
    from jiminy_torch.ops import kernels

    res = kernels.build()
    log(f"[build] {res.path.name}: {'reused' if res.reused else f'nvcc {res.seconds:.1f} s'}")
    entry = None
    for line in res.ptxas_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and ("registers" in line or ("stack frame" in line and "bytes stack" in line)):
            if "registers" in line or not line.strip().startswith("0 bytes"):
                log(f"[ptxas] {entry}: {line.strip()}")
    kernels.load()
    return res


def _rollout_inputs(env, q, dtype, device, controller, seed):
    import torch

    from jiminy_torch.ops import cdyn

    nm = env.robot.nmotors
    b = q.shape[0]
    if controller == "pd":
        ctrl = env.block.component_controller(env.env)
        action = _commands(b, nm, dtype, device, seed, scale=50.0)
        carry = torch.zeros((b, 3 * nm), dtype=dtype, device=device)
        carry[:, :nm] = q[:, 7:]
    else:
        ctrl = cdyn.ZOHPassThrough(nm)
        action = _commands(b, nm, dtype, device, seed)
        carry = torch.zeros((b, 0), dtype=dtype, device=device)
    return ctrl, action, carry


def phase_kernels_vs_plain(device):
    import torch

    from jiminy_torch.envs import make
    from jiminy_torch.testing import perturbed_states

    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        tol1, tol2 = TOL[name]
        env = make("anymal-pid", device=device, dtype=dtype)
        eng = env.env.engine
        q, v, tau = perturbed_states(env, 4096, seed=0)
        out, ref = eng._cdyn.accel_kernel(q, v, tau), eng._cdyn.accel_plain(q, v, tau)
        torch.cuda.synchronize()
        e, where = output_error((out,), (ref,), name)
        log(f"[check] cdyn_accel {name} B=4096: {ERR_NAME[name]} {e:.3e} at {where} (tol {tol1:g})")
        check(torch.isfinite(out).all() and e < tol1, f"cdyn_accel {name} disagrees: {e}")

        q, v, _ = perturbed_states(env, 64, seed=1)
        cmd = _commands(64, env.robot.nmotors, dtype, device, seed=1)
        run = eng._get_period_run("rk4")
        outs, refs = run.kernel(q, v, cmd), run.plain(q, v, cmd)
        torch.cuda.synchronize()
        e, where = output_error(outs, refs, name)
        log(f"[check] cdyn_period {name} B=64 (5 substeps): {ERR_NAME[name]} {e:.3e} at {where} "
            f"(tol {tol2:g})")
        check(all(torch.isfinite(o).all() for o in outs) and e < tol2,
              f"cdyn_period {name} disagrees: {e}")

        for controller in ("pd", "zoh"):
            ctrl, action, carry = _rollout_inputs(env, q, dtype, device, controller, 2)
            run = eng._get_rollout_run("smoke-" + controller, ctrl, env.env.n_ctrl_per_step)
            outs = run.kernel(q, v, action, carry, n_ticks=2, n_substeps=2)
            refs = run.plain(q, v, action, carry, n_ticks=2, n_substeps=2)
            torch.cuda.synchronize()
            e, where = output_error(outs, refs, name)
            log(f"[check] cdyn_rollout/{controller} {name} B=64 (2 ticks x 2 substeps): "
                f"{ERR_NAME[name]} {e:.3e} at {where} (tol {tol2:g})")
            check(all(torch.isfinite(o).all() for o in outs) and e < tol2,
                  f"cdyn_rollout/{controller} {name} disagrees: {e}")


def phase_main_path(device, smi):
    import numpy as np
    import torch

    from jiminy_torch.envs import make
    from jiminy_torch.ops import cdyn

    env = make("anymal-pid", device=device)  # float32 on the card
    action = torch.zeros(env.action_size, device=device)
    # Warm-up (allocations, first launches), outside the counted run
    st, _ = env.reset(batch_size=B_MAIN)
    st, *_ = env.step(st, action)
    torch.cuda.synchronize()

    cdyn.reset_launch_counts()
    t0 = time.perf_counter()
    st, _ = env.reset(batch_size=B_MAIN)
    torch.cuda.synchronize()
    log(f"[main] batched reset B={B_MAIN}: {(time.perf_counter() - t0) * 1e3:.1f} ms (host clock; "
        f"cdyn_accel + plain-torch aux outputs and sensors) on {smi}")
    t0 = time.perf_counter()
    for _ in range(N_STEPS):
        st, obs, reward, term, trunc, _ = env.step(st, action)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    fused_launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    log(f"[main] anymal-pid float32 B={B_MAIN}, reset + {N_STEPS} steps: launches {fused_launches}")
    check(fused_launches["cdyn_rollout"] == N_STEPS, "cdyn_rollout did not run once per step")
    check(fused_launches["cdyn_accel"] >= 1, "cdyn_accel did not run at reset")
    for name, x in (("q", st.sim.q), ("v", st.sim.v), ("reward", reward),
                    ("contact_forces", st.sim.contact_forces)):
        check(bool(torch.isfinite(x).all()), f"non-finite {name} after the main path")
    check(st.sim.q.shape == (B_MAIN, 19), "unexpected state shape")
    fell = float(term.float().mean())
    log(f"[main] base height mean {float(st.sim.q[:, 2].mean()):.4f} m, terminated share {fell:.4f}")
    check(fell == 0.0, "standing ANYmal terminated under zero actions")
    steps_per_s = B_MAIN * N_STEPS / elapsed
    log(f"[main] env-steps/s {steps_per_s:.1f} ({elapsed:.4f} s for {N_STEPS} steps, host clock) "
        f"on {smi}")

    # Per-period path: one cdyn_period launch per controller period
    env.use_fused_rollout = False
    st2, _ = env.reset(batch_size=B_MAIN)
    st2, *_ = env.step(st2, action)
    torch.cuda.synchronize()
    cdyn.reset_launch_counts()
    n_pp = 2
    t0 = time.perf_counter()
    for _ in range(n_pp):
        st2, *_ = env.step(st2, action)
    torch.cuda.synchronize()
    elapsed_pp = time.perf_counter() - t0
    period_launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    log(f"[main] per-period path, {n_pp} steps: launches {period_launches}")
    check(period_launches["cdyn_period"] == n_pp * env.env.n_ctrl_per_step,
          "cdyn_period did not run once per controller period")
    check(bool(torch.isfinite(st2.sim.q).all()), "non-finite q on the per-period path")
    log(f"[main] per-period env-steps/s {B_MAIN * n_pp / elapsed_pp:.1f} on {smi}")

    # Golden rows at float64, B=1, through the kernels (both paths)
    golden = np.loadtxt(os.path.join(ROOT, "tests", "goldens", "anymal-pid.csv"),
                        delimiter=",", skiprows=1)
    for fused, n_rows in ((True, 5), (False, 3)):
        genv = make("anymal-pid", device=device, dtype=torch.float64)
        genv.use_fused_rollout = fused
        gst, _ = genv.reset()
        zero = torch.zeros(genv.action_size, dtype=torch.float64, device=device)
        worst = 0.0
        for k in range(n_rows):
            gst, _, rew, *_ = genv.step(gst, zero)
            sim = gst.sim
            row = np.concatenate([[float(sim.t)], sim.q.cpu().numpy(), sim.v.cpu().numpy(),
                                  [float(rew)], sim.contact_forces.cpu().numpy().ravel()])
            worst = max(worst, float(np.abs(row - golden[k]).max()))
        log(f"[golden] float64 B=1 {'fused' if fused else 'per-period'}: {n_rows} rows, "
            f"max abs err {worst:.3e} (tol {GOLDEN_ATOL:g})")
        check(worst < GOLDEN_ATOL, "golden rows not reproduced through the kernels")
    return env, fused_launches, period_launches, steps_per_s, st, st2


def _time_cuda(fn, n):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_kernel_records(env, fused_launches, period_launches, smi, st, st2):
    """Each kernel at the main path's shapes (B = B_MAIN).

    - float32 on the main path's own states (`st` after the fused steps,
      `st2` after the per-period steps): the kernel timed with CUDA events,
      its plain version with the host clock, and their largest difference.
      These standing states are not checked at float32: there the
      accelerations are small differences of large contact and gravity
      forces, which float32 rounding alone moves by a large share.
    - float64 on the same states: every output column within TOL in every env.
    - float64 on perturbed states (`perturbed_states`, seed 0: feet in the
      ground, joints past their bounds, random velocities, torques, commands
      and actions): the same, except that the whole 8-tick rollout may stray
      in up to F64_CHAOS_SHARE of the envs. Beside it, the kernel against
      itself on the input moved by one ulp: the share of envs that rounding
      alone carries as far.
    - float32 on the perturbed states: every output column within TOL
      (90th percentile over envs, relative to the column's RMS).
    """
    import math

    import torch

    from jiminy_torch.envs import make
    from jiminy_torch.ops import cdyn
    from jiminy_torch.testing import perturbed_states

    device = env.device
    env64 = make("anymal-pid", device=device, dtype=torch.float64)
    engines = {torch.float32: env.env.engine, torch.float64: env64.env.engine}
    elt = 4
    nq, nv, nm = env.robot.nq, env.robot.nv, env.robot.nmotors
    env_cpu = make("anymal-pid", device="cpu", dtype=torch.float64)
    ops = plain_op_counts(env_cpu, prune_zeros=True)
    ops_generic = plain_op_counts(env_cpu, prune_zeros=False)
    log(f"[ops] plain-version ops per env, structural zeros folded away: {ops}")
    log(f"[ops] plain-version ops per env, generic formulation (what the kernels run): {ops_generic}")

    block = env.block.name
    ctrl = env.env._component_controllers[block]
    n_ticks = env.env.n_ctrl_per_step

    def fns(name, eng):
        if name == "cdyn_accel":
            return eng._cdyn.accel_kernel, eng._cdyn.accel_plain
        if name == "cdyn_period":
            run = eng._get_period_run("rk4")
        else:
            run = eng._get_rollout_run(block, ctrl, n_ticks)
        return run.kernel, run.plain

    # Main path states, float32 as stepped
    q, v = st.sim.q.contiguous(), st.sim.v.contiguous()
    tau = engines[torch.float32]._compute_efforts(st.sim.command, v)[1]
    q2, v2, cmd2 = st2.sim.q.contiguous(), st2.sim.v.contiguous(), st2.sim.command.contiguous()
    carry = st.blocks[block].reshape(B_MAIN, -1).contiguous()
    action = torch.zeros((B_MAIN, nm), dtype=torch.float32, device=device)
    main_inputs = {"cdyn_accel": (q, v, tau), "cdyn_period": (q2, v2, cmd2),
                   "cdyn_rollout": (q, v, action, carry)}

    # Perturbed states, the same values at both dtypes
    def perturbed(dtype):
        qp, vp, taup = perturbed_states(env64, B_MAIN, seed=0)
        cmdp = _commands(B_MAIN, nm, torch.float64, device, seed=0)
        _, actp, carryp = _rollout_inputs(env64, qp, torch.float64, device, "pd", 0)
        xs = {"cdyn_accel": (qp, vp, taup), "cdyn_period": (qp, vp, cmdp),
              "cdyn_rollout": (qp, vp, actp, carryp)}
        return {k: tuple(x.to(dtype) for x in val) for k, val in xs.items()}

    pert = {torch.float64: perturbed(torch.float64), torch.float32: perturbed(torch.float32)}

    n_extra = engines[torch.float32]._cdyn.n_extra(engines[torch.float32]._imu_frames)
    n_extra_r = n_extra + nm + carry.shape[1]
    io_per_env = {
        "cdyn_accel": nq + 3 * nv,
        "cdyn_period": 2 * nq + 2 * nv + nm + n_extra,
        "cdyn_rollout": 2 * nq + 2 * nv + nm + carry.shape[1] + n_extra_r,
    }
    launches = {"cdyn_accel": fused_launches["cdyn_accel"],
                "cdyn_period": period_launches["cdyn_period"],
                "cdyn_rollout": fused_launches["cdyn_rollout"]}
    n_time = {"cdyn_accel": 20, "cdyn_period": 5, "cdyn_rollout": 3}

    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def run_pair(name, dtype, xs):
        kern, plain = fns(name, engines[dtype])
        outs, refs = as_tuple(kern(*xs)), as_tuple(plain(*xs))
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(o).all()) for o in outs), f"{name}: non-finite kernel output")
        return outs, refs

    records = []
    for name in ("cdyn_accel", "cdyn_period", "cdyn_rollout"):
        integrated = name != "cdyn_accel"
        tol64 = TOL["float64"][integrated]
        tol32 = TOL["float32"][integrated]

        # float32, main path states: timing and distance
        kern32, plain32 = fns(name, engines[torch.float32])
        xs = main_inputs[name]
        ms = _time_cuda(lambda: kern32(*xs), n_time[name])
        outs = as_tuple(kern32(*xs))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs = as_tuple(plain32(*xs))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        e_abs = abs_err(outs, refs)
        del outs, refs

        # float64, main path states: every column, every env
        outs, refs = run_pair(name, torch.float64, tuple(x.double() for x in xs))
        e64_main, at64_main = output_error(outs, refs, "float64")
        log(f"[check] {name} float64 B={B_MAIN}, main path states: column max rel err "
            f"{e64_main:.3e} at {at64_main} (tol {tol64:g})")
        check(e64_main < tol64, f"{name} float64 disagrees on the main path's states: {e64_main}")
        del outs, refs

        # float64, perturbed states, with the one-ulp witness
        xs = pert[torch.float64][name]
        outs, refs = run_pair(name, torch.float64, xs)
        e64_pert, at64_pert = output_error(outs, refs, "float64")
        share = share_beyond(outs, refs, tol64)
        nudged = (torch.nextafter(xs[0], torch.full_like(xs[0], math.inf)),) + xs[1:]
        outs_n = as_tuple(fns(name, engines[torch.float64])[0](*nudged))
        share_n = share_beyond(outs_n, outs, tol64)
        e_nudge, at_nudge = output_error(outs_n, outs, "float64")
        allowed = F64_CHAOS_SHARE if name == "cdyn_rollout" else 0.0
        log(f"[check] {name} float64 B={B_MAIN}, perturbed states: column max rel err "
            f"{e64_pert:.3e} at {at64_pert}; share of envs beyond {tol64:g}: {share:.3e} "
            f"(allowed {allowed:g}); the kernel against itself with q moved one ulp: "
            f"{e_nudge:.3e} at {at_nudge}, share beyond {tol64:g}: {share_n:.3e}")
        check(share <= allowed, f"{name} float64 disagrees on perturbed states: share {share}")
        del outs, refs, outs_n

        # float32, perturbed states: per column, q90 over envs / column RMS
        outs, refs = run_pair(name, torch.float32, pert[torch.float32][name])
        e32_pert, at32_pert = output_error(outs, refs, "float32")
        log(f"[check] {name} float32 B={B_MAIN}, perturbed states: column q90 err / rms "
            f"{e32_pert:.3e} at {at32_pert} (tol {tol32:g}); max abs err {abs_err(outs, refs):.3e}")
        check(e32_pert < tol32, f"{name} float32 disagrees on perturbed states: {e32_pert}")
        del outs, refs

        t_ops = ops[name] * B_MAIN / PEAK_F32_FLOPS * 1e3
        t_ops_generic = ops_generic[name] * B_MAIN / PEAK_F32_FLOPS * 1e3
        t_bytes = io_per_env[name] * elt * B_MAIN / PEAK_BYTES * 1e3
        rec = {
            "name": name,
            "route": "cuda",
            "source": "jiminy_torch/csrc/cdyn.cu",
            "replaces": cdyn.KERNELS[name].replaces.split()[0],
            "launches": launches[name],
            "max_abs_err": e_abs,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
            "ops_per_env": ops[name],
            "ops_per_env_generic": ops_generic[name],
            "bound_ms_generic": max(t_ops_generic, t_bytes),
            "bytes_per_env": io_per_env[name] * elt,
            "f64_err_main": e64_main,
            "f64_err_perturbed": e64_pert,
            "f64_share_perturbed": share,
            "f64_share_one_ulp": share_n,
            "f32_q90_err_perturbed": e32_pert,
        }
        log(f"[kernel] {name} B={B_MAIN} float32: {ms:.3f} ms (CUDA events), plain {plain_ms:.1f} ms "
            f"(host clock), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; generic formulation "
            f"{rec['bound_ms_generic']:.4f} ms); |kernel-plain| on the main path's states "
            f"{e_abs:.3e} on {smi}")
        records.append(rec)
    return records


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}, {torch.cuda.device_count()} device(s), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi)

    t_start = time.perf_counter()
    phase_build()
    phase_kernels_vs_plain(device)
    env, fused_launches, period_launches, steps_per_s, st, st2 = phase_main_path(device, smi)
    records = phase_kernel_records(env, fused_launches, period_launches, smi, st, st2)
    log(f"[done] {time.perf_counter() - t_start:.1f} s; anymal-pid env-steps/s {steps_per_s:.1f} on {smi}")
    log(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
