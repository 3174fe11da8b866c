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
5. Adaptive DOPRI 5(4) (the same env with `dopri_options`: the C++
   reference's runge_kutta_dopri5), float32 on the card, B=131072: reset, a
   warm-up step and N_STEPS_DOPRI steps with zero actions, launch counts set
   to 0 just before and read just after: every dynamics evaluation is one
   cdyn_accel launch over the batch, 2 + 6 x trials a period (the most any
   env took), and nothing else runs. Checks: all finite, no env diverged or
   terminated. Trials a period (mean and max over the batch), env-steps/s,
   and one more step with CUDA events around each launch: the step's time
   split into kernel and glue. Then two periods from the standing robot, its
   velocities perturbed, at float64, B=256, through the kernel and through
   `accel_plain`: the same trials, q, v and a within 1e-9.
6. Kernels at the main path's shapes (B=131072): float32 on the main path's
   own states, timed (CUDA events) beside its plain version (cdyn_accel also
   on DOPRI's stage states); float64 on the same states, every column within
   1e-9 in every env; float64 and float32 on perturbed states (not at
   equilibrium), as in phase 3 (the whole 8-tick rollout is let stray
   beyond 1e-9 in at most F64_CHAOS_SHARE of the envs, with a last-bit nudge
   of the input as the witness of how far rounding alone carries them); and
   at a batch one env short (the last block of envs part-filled) against the
   same plain outputs. cdyn_accel's launches are the DOPRI path's (its main
   path now; one more at every reset). The bound is max(bytes / 3.35 TB/s,
   ops / 67 TFLOP/s) from this run's shapes and an op count of the plain
   version (one torch elementwise call per op, counted on the CPU with a
   TorchFunctionMode) with the model's structural zeros folded away; the
   generic formulation's count, zeros included, is printed beside it.
7. Constrained path (anymal-pid in constraint contact mode, ground contacts
   and joint bounds through the PGS solver, as bench.py builds it with
   BENCH_CONTACT=constraint), float32 on the card: batched reset at B=131072
   (the plain constrained solve, timed), 25 steps with zero actions through
   cdyn_rollout_cm (launch counts set to 0 before, read after), then the
   per-period path through cdyn_period_cm; physics checks on the final
   state (all finite, none terminated, the feet carry the robot's weight
   within 5 %, joints within their limits, multipliers inside their boxes
   and friction cones).
8. The constrained kernels at B=131072: float32 on the main path's states,
   timed against the plain version at the full tick and substep counts; float64 on the main path's
   states and float64 and float32 on states with active rows
   (`constrained_inputs`), with every row and with no row active, and at a
   batch one env short (the last block part-filled), at 2 ticks x 2
   substeps (a plain constrained step is millions of eager launches), per
   column as in phase 3; and witnesses that the check fails for a zeroed
   multiplier column and for a solver stopped after one sweep. Ops are
   counted on the plain version per scalar element at B=1 on a main-path
   state, those with an exactly-zero operand (structural or inactive-row
   zeros) folded away.

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
N_STEPS_CM = 25  # constrained main path
N_STEPS_DOPRI = 5  # DOPRI main path
B_DOPRI_F64 = 256  # DOPRI kernel-vs-plain periods
CM_TICKS, CM_SUBSTEPS = 2, 2  # cut of the constrained kernel-vs-plain checks
CM_WEIGHT_TOL = 0.05  # feet carry m g within this share at rest
CM_JOINT_SLACK = 1e-2  # [rad] beyond a joint limit
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


def _dopri_make(device, dtype=None):
    from jiminy_torch.envs import make
    from jiminy_torch.testing import dopri_options

    options = make("anymal-pid", device=device, dtype=dtype).engine.options
    return make("anymal-pid", device=device, dtype=dtype, options=dopri_options(options))


def _period_trials(periods):
    """Trials each env took in each recorded period (accepted + rejected)."""
    return [(b.iterations + b.iter_failed) - (a.iterations + a.iter_failed) for a, b in periods]


def _recording(eng, periods):
    """`eng.step` that keeps each period's stepper states (before, after)."""
    step = type(eng).step

    def recorded(state, command=None):
        out = step(eng, state, command)
        periods.append((state.stepper, out.stepper))
        return out

    return recorded


def dopri_glue_calls():
    """Torch calls a DOPRI trial and a period make outside cdyn_accel (the
    glue), counted on the CPU at B=2, float64: one period from rest (few
    trials) and one from a perturbed state (more), solved for the two."""
    import numpy as np
    import torch
    from torch.overrides import TorchFunctionMode

    env = _dopri_make("cpu", torch.float64)
    eng, cd = env.engine, env.engine._cdyn

    class Counter(TorchFunctionMode):
        n, inside = 0, 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            Counter.n += Counter.inside == 0
            return func(*args, **(kwargs or {}))

    def accel(q, v, tau):
        Counter.inside += 1
        try:
            return type(cd).accel(cd, q, v, tau)
        finally:
            Counter.inside -= 1

    rng = np.random.default_rng(0)
    q = env.nominal_q.expand(2, -1).clone()
    v = torch.zeros((2, env.robot.nv), dtype=torch.float64)
    points = []
    for scale in (0.0, 1.0):
        q[1, 7:] += torch.as_tensor(rng.normal(size=12) * 0.05 * scale)
        v[1] = torch.as_tensor(rng.normal(size=env.robot.nv) * 0.3 * scale)
        st = eng.reset(q, v)
        cd.accel, Counter.n = accel, 0
        with torch.no_grad(), Counter():
            st1 = eng.step(st, torch.zeros((2, env.robot.nmotors), dtype=torch.float64))
        del cd.accel
        points.append((int((st1.stepper.iterations + st1.stepper.iter_failed).max()), Counter.n))
    (t0, n0), (t1, n1) = points
    per_trial = (n1 - n0) / (t1 - t0)
    return per_trial, n0 - per_trial * t0


def phase_dopri(device, smi):
    """Adaptive DOPRI on the card (phase 5): the main path, its launches and
    trials, the kernel/glue split, and the kernel against the plain version
    over two periods at float64."""
    import numpy as np
    import torch

    from jiminy_torch.ops import cdyn
    from jiminy_torch.testing import column_errors

    env = _dopri_make(device)  # float32
    eng = env.engine
    action = torch.zeros(env.action_size, device=device)
    st, _ = env.reset(batch_size=B_MAIN)
    st, *_ = env.step(st, action)  # warm-up, outside the counted run
    torch.cuda.synchronize()

    periods = []
    eng.step = _recording(eng, periods)
    cdyn.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(N_STEPS_DOPRI):
        st, obs, reward, term, trunc, _ = env.step(st, action)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    del eng.step
    trials = torch.stack(_period_trials(periods)).double()  # (periods, B)
    loops = [int(t.max()) for t in trials]
    want = sum(2 + 6 * n for n in loops)
    log(f"[dopri] anymal-pid DOPRI float32 B={B_MAIN}, {N_STEPS_DOPRI} steps ({len(periods)} "
        f"periods): launches {launches}; trials a period: mean {float(trials.mean()):.4f}, max "
        f"{int(trials.max())}, loop iterations {loops}; 2 + 6 x trials summed over periods: {want}")
    check(launches["cdyn_accel"] == want, "cdyn_accel did not run once per DOPRI evaluation")
    check(sum(launches.values()) == want, "a kernel other than cdyn_accel ran on the DOPRI path")
    sim = st.sim
    for name, x in (("q", sim.q), ("v", sim.v), ("a", sim.a), ("reward", reward),
                    ("contact_forces", sim.contact_forces), ("dt", sim.stepper.dt)):
        check(bool(torch.isfinite(x).all()), f"non-finite {name} on the DOPRI path")
    check(not bool(sim.stepper.diverged.any()), "a DOPRI env diverged")
    fell = float(term.float().mean())
    check(fell == 0.0, "standing ANYmal terminated under DOPRI and zero actions")
    steps_per_s = B_MAIN * N_STEPS_DOPRI / elapsed
    log(f"[dopri] env-steps/s {steps_per_s:.1f} ({elapsed:.4f} s for {N_STEPS_DOPRI} steps, host "
        f"clock; base height mean {float(sim.q[:, 2].mean()):.4f} m, dt mean "
        f"{float(sim.stepper.dt.double().mean()):.3e}) on {smi}")

    # One more step, CUDA events around every launch; the stage inputs kept
    cd, events, stage = eng._cdyn, [], []

    def timed(q, v, tau):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = type(cd).accel(cd, q, v, tau)
        b.record()
        events.append((a, b))
        stage.append((q, v, tau))
        return out

    cd.accel = timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, *_ = env.step(st, action)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    del cd.accel
    bracket_ms = sum(a.elapsed_time(b) for a, b in events)
    stage_inputs = tuple(x.contiguous() for x in stage[len(stage) // 2])
    launch_ms = _time_cuda(lambda: cd.accel(*stage_inputs), 20)
    kernel_ms = len(events) * launch_ms
    per_trial, per_period = dopri_glue_calls()
    n_periods = env.env.n_ctrl_per_step
    calls = per_period * n_periods + per_trial * (len(events) - 2 * n_periods) / 6
    log(f"[dopri] glue: {per_trial:.0f} torch calls a trial and {per_period:.0f} a period outside "
        f"cdyn_accel (counted on the CPU at B=2), so {calls:.0f} in the step below")
    log(f"[dopri] one step: {step_ms:.2f} ms (host clock); its {len(events)} cdyn_accel calls "
        f"{bracket_ms:.2f} ms between CUDA events around each (the kernel and the wrapper's host "
        f"work, which the idle card waits on), of which kernel {kernel_ms:.2f} ms ({len(events)} x "
        f"{launch_ms:.4f} ms, back-to-back launches on a stage state); glue "
        f"{step_ms - kernel_ms:.2f} ms ({(step_ms - kernel_ms) / step_ms:.1%} of the step) on {smi}")
    del stage, events

    # Two periods at float64 from the standing robot of the main path, its
    # velocities perturbed: the kernel against the plain version
    env64 = _dopri_make(device, torch.float64)
    eng64 = env64.engine
    rng = np.random.default_rng(0)
    v0 = rng.normal(size=(B_DOPRI_F64, env64.robot.nv)) * 0.05
    st0 = eng64.reset(st.sim.q[:B_DOPRI_F64].double(),
                      st.sim.v[:B_DOPRI_F64].double() + torch.as_tensor(v0, device=device))
    cmd = torch.zeros((B_DOPRI_F64, env64.robot.nmotors), dtype=torch.float64, device=device)
    runs = {}
    for route in ("kernel", "plain"):
        if route == "plain":
            eng64._cdyn.accel = eng64._cdyn.accel_plain
        x = st0
        for _ in range(2):
            x = eng64.step(x, cmd)
        runs[route] = x
    del eng64._cdyn.accel
    torch.cuda.synchronize()
    k, p = runs["kernel"], runs["plain"]
    tk, tp = (r.stepper.iterations + r.stepper.iter_failed for r in (k, p))
    e64 = max(float(column_errors(a, b).max()) for a, b in ((k.q, p.q), (k.v, p.v), (k.a, p.a)))
    log(f"[dopri] float64 B={B_DOPRI_F64}, two periods, velocities perturbed: trials kernel / plain mean "
        f"{float(tk.double().mean()):.3f} / {float(tp.double().mean()):.3f}, max {int(tk.max())} / "
        f"{int(tp.max())}, equal in every env: {bool(torch.equal(tk, tp))}; q, v, a column max "
        f"rel err {e64:.3e} (tol {TOL['float64'][1]:g})")
    check(bool(torch.equal(tk, tp)), "DOPRI took other trials through the kernel than the plain path")
    check(e64 < TOL["float64"][1], f"DOPRI periods through the kernel disagree at float64: {e64}")
    return {"launches": launches["cdyn_accel"], "steps_per_s": steps_per_s,
            "trials_mean": float(trials.mean()), "trials_max": int(trials.max()),
            "step_ms": step_ms, "kernel_ms": kernel_ms, "bracket_ms": bracket_ms,
            "glue_calls_per_trial": per_trial, "glue_calls_per_period": per_period,
            "f64_err_periods": e64,
            "stage_inputs": stage_inputs}


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


def phase_kernel_records(env, fused_launches, period_launches, smi, st, st2, dopri):
    """Each kernel at the main path's shapes (B = B_MAIN).

    - float32 on the main path's own states (`st` after the fused steps,
      `st2` after the per-period steps): the kernel timed with CUDA events,
      its plain version with the host clock, and their largest difference;
      cdyn_accel also timed on a DOPRI trial's stage states (`dopri`, phase 5).
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
    launches = {"cdyn_accel": dopri["launches"],
                "cdyn_period": period_launches["cdyn_period"],
                "cdyn_rollout": fused_launches["cdyn_rollout"]}
    n_time = {"cdyn_accel": 20, "cdyn_period": 5, "cdyn_rollout": 3}
    # The spring kernels' launch geometry and shared memory an env
    from jiminy_torch.ops import kernels

    c = engines[torch.float32]._cdyn.pack(None, 0.0, (), device, torch.float32).counts
    geometry = {}
    lib = kernels.load()
    for name, widths in (("cdyn_accel", None), ("cdyn_period", (nm, 0, 0)),
                         ("cdyn_rollout", (nm, nm, carry.shape[1]))):
        per_env = {elt: lib.accel_smem_bytes(c["nj"], c["nq"], c["nv"], c["nc"], elt)
                   if widths is None else
                   lib.sp_smem_bytes(c["nj"], c["nq"], c["nv"], c["nc"], *widths, elt)
                   for elt in (4, 8)}
        lanes, envs = per_env[4][1:]
        per_sm = {elt: lib.sp_envs_per_sm(name, elt, per_env[elt][0]) for elt in (4, 8)}
        geometry[name] = {"lanes_per_env": lanes, "envs_per_block": envs,
                          "smem_per_env": per_env[4][0], "smem_per_env_f64": per_env[8][0],
                          "envs_per_sm": per_sm[4], "envs_per_sm_f64": per_sm[8]}
        log(f"[smem] {name}: {lanes} lanes an env, {envs} envs a block; {per_env[4][0]} B of shared "
            f"memory an env at float32, {per_env[8][0]} B at float64 ({envs * per_env[4][0]} / "
            f"{envs * per_env[8][0]} B a block); the runtime keeps {per_sm[4]} / {per_sm[8]} envs "
            f"an SM")

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
        ms_stage = None
        if name == "cdyn_accel":
            ms_stage = _time_cuda(lambda: kern32(*dopri["stage_inputs"]), n_time[name])
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
        # the last block of envs part-filled, against the same plain outputs
        b_rag = B_MAIN - 1
        outs_rag = as_tuple(fns(name, engines[torch.float64])[0](*(x[:b_rag] for x in xs)))
        share_rag = share_beyond(outs_rag, tuple(r[:b_rag] for r in refs), tol64)
        log(f"[check] {name} float64 B={b_rag} (ragged), perturbed states: share of envs "
            f"beyond {tol64:g}: {share_rag:.3e} (allowed {allowed:g})")
        check(all(bool(torch.isfinite(o).all()) for o in outs_rag), f"{name}: non-finite output")
        check(share_rag <= allowed, f"{name} float64 disagrees at B={b_rag}: {share_rag}")
        del outs_rag
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
            "source": "jiminy_torch/csrc/spring.cuh",
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
            "f64_share_ragged": share_rag,
            **({"ms_dopri_stage": ms_stage, "launches_path": "dopri",
                "dopri_trials_mean": dopri["trials_mean"], "dopri_trials_max": dopri["trials_max"],
                "dopri_env_steps_per_s": dopri["steps_per_s"]} if ms_stage else {}),
            **geometry.get(name, {}),
        }
        stage_note = f" ({ms_stage:.4f} ms on DOPRI stage states)" if ms_stage else ""
        log(f"[kernel] {name} B={B_MAIN} float32: {ms:.4f} ms{stage_note} (CUDA events), plain {plain_ms:.1f} ms "
            f"(host clock), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; generic formulation "
            f"{rec['bound_ms_generic']:.4f} ms); |kernel-plain| on the main path's states "
            f"{e_abs:.3e} on {smi}")
        records.append(rec)
    return records


# --------------------------------------------------------------------------- #
# Constrained path (PGS): cdyn_period_cm and cdyn_rollout_cm
# --------------------------------------------------------------------------- #


def count_elem_ops(fn, fold_zeros):
    """Scalar operations per env of `fn` run at B=1: each elementwise torch
    call counts one per output element, a sum n - 1 per output; with
    `fold_zeros`, additions, multiplications and divisions with an operand
    element exactly 0 (or a factor exactly 1) are not counted."""
    import torch
    from torch.overrides import TorchFunctionMode

    arith = {"add", "radd", "sub", "rsub", "mul", "rmul", "div", "truediv", "rtruediv"}

    def elems(x, shape, pred):
        if isinstance(x, torch.Tensor):
            return pred(x).expand(shape)
        return torch.full(shape, bool(pred(torch.tensor(float(x)))))

    class Counter(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            out = func(*args, **(kwargs or {}))
            if not isinstance(out, torch.Tensor):
                return out
            if name == "sum":
                terms = args[0].count_nonzero() if fold_zeros else args[0].numel()
                Counter.n += max(int(terms) - out.numel(), 0)
                return out
            if name not in _COUNTED:
                return out
            key = name.strip("_")
            if fold_zeros and key in arith:
                a, b = args[0], args[1]
                if key in ("rsub", "rtruediv"):
                    a, b = b, a
                shape = out.shape
                live = elems(a, shape, lambda x: x != 0)
                if key in ("mul", "rmul"):
                    live = live & elems(b, shape, lambda x: x != 0)
                    live = live & elems(a, shape, lambda x: x != 1) & elems(b, shape, lambda x: x != 1)
                elif key in ("add", "radd", "sub"):
                    live = live & elems(b, shape, lambda x: x != 0)
                else:  # division: zero numerator or unit denominator
                    live = live & elems(b, shape, lambda x: x != 1)
                Counter.n += int(live.sum())
                return out
            Counter.n += out.numel()
            return out

    with torch.no_grad(), Counter():
        fn()
    return Counter.n


def _cm_make(device, dtype):
    from jiminy_torch.envs import make
    from jiminy_torch.testing import constraint_mode_options

    options = make("anymal-pid", device=device, dtype=dtype).engine.options
    return make("anymal-pid", device=device, dtype=dtype, options=constraint_mode_options(options))


def _cm_solver_row(sim, dtype):
    import torch

    return torch.cat([sim.lam, sim.contact_active.to(dtype), sim.bound_active.to(dtype)], dim=-1)


def phase_constrained_main_path(device, smi):
    import torch

    from jiminy_torch.ops import cdyn

    env = _cm_make(device, torch.float32)
    eng = env.engine
    action = torch.zeros(env.action_size, device=device)
    st, _ = env.reset(batch_size=B_MAIN)  # warm-up, outside the counted run
    st, *_ = env.step(st, action)
    torch.cuda.synchronize()

    cdyn.reset_launch_counts()
    t0 = time.perf_counter()
    st, _ = env.reset(batch_size=B_MAIN)
    torch.cuda.synchronize()
    reset_ms = (time.perf_counter() - t0) * 1e3
    log(f"[cm-main] batched reset B={B_MAIN}: {reset_ms:.1f} ms (host clock; the plain "
        f"constrained solve, torch ops on the card) on {smi}")
    t0 = time.perf_counter()
    for _ in range(N_STEPS_CM):
        st, obs, reward, term, trunc, _ = env.step(st, action)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    log(f"[cm-main] anymal-pid constraint mode float32 B={B_MAIN}, reset + {N_STEPS_CM} steps: "
        f"launches {launches}")
    check(launches["cdyn_rollout_cm"] == N_STEPS_CM and sum(launches.values()) == N_STEPS_CM,
          "cdyn_rollout_cm did not run once per step (and nothing else)")
    sim = st.sim
    for name, x in (("q", sim.q), ("v", sim.v), ("reward", reward), ("lam", sim.lam),
                    ("contact_forces", sim.contact_forces)):
        check(bool(torch.isfinite(x).all()), f"non-finite {name} on the constrained main path")
    fell = float(term.float().mean())
    check(fell == 0.0, "standing ANYmal terminated in constraint mode under zero actions")
    steps_per_s = B_MAIN * N_STEPS_CM / elapsed
    log(f"[cm-main] env-steps/s {steps_per_s:.1f} ({elapsed:.4f} s for {N_STEPS_CM} steps, host "
        f"clock) on {smi}")
    physics_checks(env, sim)

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
    n_periods = n_pp * env.env.n_ctrl_per_step
    log(f"[cm-main] per-period path, {n_pp} steps: launches {period_launches}")
    check(period_launches["cdyn_period_cm"] == n_periods
          and sum(period_launches.values()) == n_periods,
          "cdyn_period_cm did not run once per controller period (and nothing else)")
    check(bool(torch.isfinite(st2.sim.q).all()), "non-finite q on the constrained per-period path")
    pp_steps_per_s = B_MAIN * n_pp / elapsed_pp
    log(f"[cm-main] per-period env-steps/s {pp_steps_per_s:.1f} on {smi}")
    env.use_fused_rollout = True
    return env, launches, period_launches, steps_per_s, pp_steps_per_s, reset_ms, st, st2


def physics_checks(env, sim):
    """Checks a zeroed or wrong solver fails, on the final state of the
    constrained main path (the robot at rest on its four feet)."""
    import numpy as np
    import torch

    eng = env.engine
    cset, model = eng.cset, env.robot.model
    nb, mu = cset.n_bounds, eng.options.contacts.friction
    weight = float(np.sum(model.mass)) * -eng.options.world.gravity[2]
    fz = sim.contact_forces[..., 2].sum(-1).double()
    worst = float(((fz - weight).abs() / weight).max())
    log(f"[cm-physics] sum of normal forces / (m g = {weight:.3f} N): worst env off by {worst:.3e} "
        f"(tol {CM_WEIGHT_TOL:g})")
    check(worst < CM_WEIGHT_TOL, "the feet do not carry the robot's weight")
    qi = [model.idx_q[j] for j in cset.bound_joint_indices]
    q = sim.q[:, qi].double()
    lo = torch.as_tensor(model.position_limit_lower[qi], device=q.device)
    hi = torch.as_tensor(model.position_limit_upper[qi], device=q.device)
    over = float(torch.clamp(torch.maximum(lo - q, q - hi), min=0.0).max())
    log(f"[cm-physics] joints past their limits by at most {over:.3e} rad (slack {CM_JOINT_SLACK:g})")
    check(over <= CM_JOINT_SLACK, "a joint is past its limit")
    lam = sim.lam.double()
    lam_b, lam_n = lam[:, :nb], lam[:, nb + 2::4]
    lam_t = torch.hypot(lam[:, nb::4], lam[:, nb + 1::4])
    cone = float((lam_t - mu * lam_n * (1 + 1e-5)).max())
    log(f"[cm-physics] min bound multiplier {float(lam_b.min()):.3e}, min normal multiplier "
        f"{float(lam_n.min()):.3e}, max ||lam_t|| - mu lam_n (1 + 1e-5) {cone:.3e}")
    check(float(lam_b.min()) >= 0.0 and float(lam_n.min()) >= 0.0, "negative boxed multiplier")
    check(cone <= 0.0, "a tangential multiplier is outside the friction cone")


def constrained_op_counts(env_cpu, st, fold_zeros):
    """Ops per env of one constrained period (5 substeps) and one env step
    (8 ticks), counted on the plain version at B=1 on env 0 of the main
    path's final state: period = 5 substeps + the final solve; step = 8 x
    (controller + 5 substeps) + 7 end-of-tick solves + the final solve."""
    import torch

    eng = env_cpu.engine
    sim = st.sim
    q = sim.q[:1].double().cpu()
    v = sim.v[:1].double().cpu()
    qc, vc = [q[..., i] for i in range(q.shape[-1])], [v[..., i] for i in range(v.shape[-1])]
    cc = torch.cat([sim.command[:1].double().cpu(), _cm_solver_row(sim, torch.float64)[:1].cpu()], -1)
    ccl = [cc[..., i] for i in range(cc.shape[-1])]
    run = eng._get_period_run("rk4")
    ctrl = env_cpu.block.component_controller(env_cpu.env)
    rrun = eng._get_rollout_run("count", ctrl, env_cpu.env.n_ctrl_per_step)
    block = st.blocks[env_cpu.block.name][:1].reshape(1, -1).double().cpu()
    bc = torch.cat([block, _cm_solver_row(sim, torch.float64)[:1].cpu()], -1)
    bcl = [bc[..., i] for i in range(bc.shape[-1])]
    acl = [torch.zeros(1, dtype=torch.float64)] * env_cpu.action_size

    def count(fn):
        return count_elem_ops(fn, fold_zeros)

    sub = count(lambda: run.substep(qc, vc, ccl))
    fin = count(lambda: run.final_outputs(qc, vc, ccl))
    ctl = count(lambda: rrun.controller_fn(qc, vc, bcl, acl))
    post = count(lambda: rrun.post_tick_fn(qc, vc, ccl, bcl))
    n_sub, n_ticks = run.n_substeps, rrun.n_ticks
    return {
        "cdyn_period_cm": n_sub * sub + fin,
        "cdyn_rollout_cm": n_ticks * (ctl + n_sub * sub) + (n_ticks - 1) * post + fin,
        "one constrained solve (final outputs)": fin,
    }


def phase_constrained_records(env, launches, period_launches, smi, st, st2):
    """The two constrained kernels at B = B_MAIN, records for the kernels line."""
    import dataclasses
    import math

    import torch

    from jiminy_torch.engine import solver
    from jiminy_torch.ops import cdyn
    from jiminy_torch.testing import column_errors, column_quantile_errors, constrained_inputs

    device = env.device
    env64 = _cm_make(device, torch.float64)
    engines = {torch.float32: env.engine, torch.float64: env64.engine}
    nm = env.robot.nmotors
    block = env.block.name
    ctrl = env.env._component_controllers[block]
    n_ticks = env.env.n_ctrl_per_step

    env_cpu = _cm_make("cpu", torch.float64)
    ops = constrained_op_counts(env_cpu, st, fold_zeros=True)
    ops_generic = constrained_op_counts(env_cpu, st, fold_zeros=False)
    log(f"[cm-ops] plain-version scalar ops per env at the main path's state, zero operands "
        f"folded away: {ops}")
    log(f"[cm-ops] the same, every element op: {ops_generic}")

    def run_of(name, eng, opts=None):
        if name == "cdyn_period_cm":
            run = eng._get_period_run("rk4")
            if opts is not None:
                run = solver.ConstrainedPeriodIntegrator(run.cd, run.tau_c, run.cset, opts, run.dt,
                                                         run.n_substeps, run.integrator,
                                                         run.n_cmd, run.imu_frames)
            return run
        run = eng._get_rollout_run(block, ctrl, n_ticks)
        if opts is not None:
            run = solver.ConstrainedRolloutIntegrator(run.cd, run.tau_c, run.cset, opts, run.dt,
                                                      run.n_substeps, run.n_ticks, ctrl,
                                                      run.integrator, run.imu_frames)
        return run

    def reduced(name):
        if name == "cdyn_period_cm":
            return dict(n_substeps=CM_SUBSTEPS)
        return dict(n_ticks=CM_TICKS, n_substeps=CM_SUBSTEPS)

    # Main path states, float32 as stepped
    main_inputs = {
        "cdyn_period_cm": (st2.sim.q, st2.sim.v,
                           torch.cat([st2.sim.command, _cm_solver_row(st2.sim, torch.float32)], -1)),
        "cdyn_rollout_cm": (st.sim.q, st.sim.v, torch.zeros((B_MAIN, nm), device=device),
                            torch.cat([st.blocks[block].reshape(B_MAIN, -1),
                                       _cm_solver_row(st.sim, torch.float32)], -1)),
    }
    # States with active rows (and with every row, or no row, active at the
    # first solve), the same values at both dtypes
    def inputs_of(rows):
        qa, va, cmda, sola = constrained_inputs(env64, B_MAIN, seed=0, rows=rows)
        blk = torch.zeros((B_MAIN, 3 * nm), dtype=torch.float64, device=device)
        blk[:, :nm] = qa[:, 7:]
        return {"cdyn_period_cm": (qa, va, torch.cat([cmda, sola], -1)),
                "cdyn_rollout_cm": (qa, va, cmda * 2.5, torch.cat([blk, sola], -1))}

    active = inputs_of("mixed")
    extremes = {rows: inputs_of(rows) for rows in ("all", "none")}
    nq, nv = env.robot.nq, env.robot.nv
    cset = env.engine.cset
    n_solver = cset.total_rows + cset.n_contacts + cset.n_bounds
    n_extra = nv + 10 * cset.n_contacts + 6 * len(env.engine._imu_frames) + n_solver
    n_cc, n_carry = nm + n_solver, 3 * nm + n_solver
    io_per_env = {
        "cdyn_period_cm": 2 * nq + 2 * nv + n_cc + n_extra,
        "cdyn_rollout_cm": 2 * nq + 2 * nv + nm + n_carry + n_extra + n_cc + n_carry,
    }
    lam_cols = slice(n_extra - n_solver, n_extra - n_solver + cset.total_rows)
    n_launch = {"cdyn_period_cm": period_launches["cdyn_period_cm"],
                "cdyn_rollout_cm": launches["cdyn_rollout_cm"]}
    run32 = run_of("cdyn_rollout_cm", engines[torch.float32])
    packed = run32.cd.pack(run32.tau_c, run32.dt, run32.imu_frames, device, torch.float32)
    smem_per_env = solver.cm_smem_per_env(packed, run32.pack(device, torch.float32), torch.float32)
    n_time = {"cdyn_period_cm": 5, "cdyn_rollout_cm": 3}
    tol64, tol32 = TOL["float64"][1], TOL["float32"][1]
    records = []
    for name in ("cdyn_period_cm", "cdyn_rollout_cm"):
        # float32, main path states, full tick and substep counts: timing
        run32 = run_of(name, engines[torch.float32])
        xs = main_inputs[name]
        ms = _time_cuda(lambda: run32.kernel(*xs), n_time[name])
        outs = run32.kernel(*xs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs = run32.plain(*xs)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        e_abs = abs_err(outs, refs)
        del outs, refs

        # float64, main path states, reduced counts: every column, every env
        run64 = run_of(name, engines[torch.float64])
        xs64 = tuple(x.double() for x in xs)
        outs, refs = run64.kernel(*xs64, **reduced(name)), run64.plain(*xs64, **reduced(name))
        torch.cuda.synchronize()
        e64_main, at64_main = output_error(outs, refs, "float64")
        log(f"[cm-check] {name} float64 B={B_MAIN} ({reduced(name)}), main path states: column "
            f"max rel err {e64_main:.3e} at {at64_main} (tol {tol64:g})")
        check(all(bool(torch.isfinite(o).all()) for o in outs) and e64_main < tol64,
              f"{name} float64 disagrees on the main path's states: {e64_main}")
        del outs, refs

        # float64, active rows, reduced counts; the one-ulp and the solver witnesses
        xs = active[name]
        outs, refs = run64.kernel(*xs, **reduced(name)), run64.plain(*xs, **reduced(name))
        torch.cuda.synchronize()
        e64, at64 = output_error(outs, refs, "float64")
        share = share_beyond(outs, refs, tol64)
        nudged = (torch.nextafter(xs[0], torch.full_like(xs[0], math.inf)),) + xs[1:]
        share_n = share_beyond(run64.kernel(*nudged, **reduced(name)), outs, tol64)
        zeroed = outs[2].clone()
        zeroed[:, lam_cols] = 0.0
        e_zero = float(column_errors(zeroed, refs[2]).max())
        one_sweep = run_of(name, engines[torch.float64],
                           dataclasses.replace(run64.opts, iter_max=1))
        outs1 = one_sweep.kernel(*xs, **reduced(name))
        e_sweep, at_sweep = output_error(outs1, refs, "float64")
        b_rag = B_MAIN - 1  # the last block of envs part-filled
        outs_rag = run64.kernel(*(x[:b_rag] for x in xs), **reduced(name))
        share_rag = share_beyond(outs_rag, tuple(r[:b_rag] for r in refs), tol64)
        del outs_rag
        log(f"[cm-check] {name} float64 B={B_MAIN} ({reduced(name)}), active rows: column max rel "
            f"err {e64:.3e} at {at64}, share of envs beyond {tol64:g}: {share:.3e} (allowed "
            f"{F64_CHAOS_SHARE:g}); with q moved one ulp the kernel moves {share_n:.3e} of envs "
            f"as far; witnesses: lambda columns zeroed {e_zero:.3e}, one PGS sweep {e_sweep:.3e} "
            f"at {at_sweep}")
        check(all(bool(torch.isfinite(o).all()) for o in outs), f"{name}: non-finite output")
        check(share <= F64_CHAOS_SHARE, f"{name} float64 disagrees on active rows: share {share}")
        check(e_zero > tol64 and e_sweep > tol64, f"{name}: the float64 check misses a wrong solver")
        log(f"[cm-check] {name} float64 B={b_rag} (ragged), active rows: share of envs beyond "
            f"{tol64:g}: {share_rag:.3e}")
        check(share_rag <= F64_CHAOS_SHARE, f"{name} float64 disagrees at B={b_rag}: {share_rag}")
        del outs, refs, outs1

        # float32, active rows, reduced counts: q90 per column; the witnesses again
        run32 = run_of(name, engines[torch.float32])
        xs32 = tuple(x.float() for x in xs)
        outs, refs = run32.kernel(*xs32, **reduced(name)), run32.plain(*xs32, **reduced(name))
        torch.cuda.synchronize()
        e32, at32 = output_error(outs, refs, "float32")
        zeroed = outs[2].clone()
        zeroed[:, lam_cols] = 0.0
        e32_zero = float(column_quantile_errors(zeroed, refs[2]).max())
        one_sweep = run_of(name, engines[torch.float32],
                           dataclasses.replace(run32.opts, iter_max=1))
        e32_sweep, _ = output_error(one_sweep.kernel(*xs32, **reduced(name)), refs, "float32")
        log(f"[cm-check] {name} float32 B={B_MAIN} ({reduced(name)}), active rows: column q90 "
            f"err / rms {e32:.3e} at {at32} (tol {tol32:g}); witnesses: lambda columns zeroed "
            f"{e32_zero:.3e}, one PGS sweep {e32_sweep:.3e}")
        check(e32 < tol32, f"{name} float32 disagrees on active rows: {e32}")
        check(e32_zero > tol32 and e32_sweep > tol32, f"{name}: the float32 check misses a wrong solver")
        del outs, refs

        # Every row active, no row active; a batch that leaves the last block part-filled
        extreme_errs = {}
        for rows, batch in extremes.items():
            xs = batch[name]
            outs, refs = run64.kernel(*xs, **reduced(name)), run64.plain(*xs, **reduced(name))
            torch.cuda.synchronize()
            e64x, at64x = output_error(outs, refs, "float64")
            share_x = share_beyond(outs, refs, tol64)
            lam_x = refs[2][:, lam_cols]
            n_act = float((lam_x != 0).double().sum(-1).mean())
            check(all(bool(torch.isfinite(o).all()) for o in outs), f"{name}: non-finite output")
            check(share_x <= F64_CHAOS_SHARE, f"{name} float64 disagrees ({rows} rows active): "
                  f"share {share_x}")
            if rows == "none":
                check(bool((outs[2][:, lam_cols] == 0).all()), f"{name}: a multiplier with no row active")
            del outs, refs
            xs32 = tuple(x.float() for x in xs)
            outs, refs = run32.kernel(*xs32, **reduced(name)), run32.plain(*xs32, **reduced(name))
            torch.cuda.synchronize()
            e32x, at32x = output_error(outs, refs, "float32")
            check(e32x < tol32, f"{name} float32 disagrees ({rows} rows active): {e32x}")
            del outs, refs
            log(f"[cm-check] {name} B={B_MAIN} ({reduced(name)}), {rows} rows active at the first "
                f"solve ({n_act:.2f} nonzero multipliers per env at the end): float64 column max "
                f"rel err {e64x:.3e} at {at64x}, share beyond {tol64:g} {share_x:.3e}; float32 "
                f"q90 {e32x:.3e} at {at32x}")
            extreme_errs[rows] = (e64x, share_x, e32x)

        t_ops = ops[name] * B_MAIN / PEAK_F32_FLOPS * 1e3
        t_ops_generic = ops_generic[name] * B_MAIN / PEAK_F32_FLOPS * 1e3
        t_bytes = io_per_env[name] * 4 * B_MAIN / PEAK_BYTES * 1e3
        rec = {
            "name": name,
            "route": "cuda",
            "source": "jiminy_torch/csrc/pgs.cuh",
            "replaces": cdyn.KERNELS[name].replaces.split()[0],
            "launches": n_launch[name],
            "max_abs_err": e_abs,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
            "ops_per_env": ops[name],
            "ops_per_env_generic": ops_generic[name],
            "bound_ms_generic": max(t_ops_generic, t_bytes),
            "bytes_per_env": io_per_env[name] * 4,
            "f64_err_main": e64_main,
            "f64_err_active": e64,
            "f64_share_active": share,
            "f64_share_one_ulp": share_n,
            "f32_q90_err_active": e32,
            "f64_err_all_active": extreme_errs["all"][0],
            "f64_err_none_active": extreme_errs["none"][0],
            "f32_q90_err_all_active": extreme_errs["all"][2],
            "f64_share_ragged": share_rag,
            "smem_per_env": smem_per_env,
        }
        log(f"[kernel] {name} B={B_MAIN} float32: {ms:.3f} ms (CUDA events), plain {plain_ms:.1f} ms "
            f"(host clock), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; every element op "
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
    dopri = phase_dopri(device, smi)
    records = phase_kernel_records(env, fused_launches, period_launches, smi, st, st2, dopri)
    del env, st, st2
    cm = phase_constrained_main_path(device, smi)
    cm_env, cm_launches, cm_period_launches, cm_steps_per_s, _, cm_reset_ms, cm_st, cm_st2 = cm
    records += phase_constrained_records(cm_env, cm_launches, cm_period_launches, smi, cm_st,
                                         cm_st2)
    log(f"[done] {time.perf_counter() - t_start:.1f} s; anymal-pid env-steps/s {steps_per_s:.1f}, "
        f"DOPRI {dopri['steps_per_s']:.1f}, constraint mode {cm_steps_per_s:.1f} (reset "
        f"{cm_reset_ms:.1f} ms) on {smi}")
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
