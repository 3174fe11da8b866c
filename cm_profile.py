#!/usr/bin/env python3
"""Launch geometry and phase split of the constrained (PGS) kernels on one
NVIDIA GPU.

    python3 cm_profile.py [--steps N] [--against DIR] [--default-only]
    python3 cm_profile.py --models --against DIR [--steps N] [--only NAME,...]
                          [--variant DEFINE,...]

Builds csrc/cdyn.cu at once for each candidate launch geometry of the
constrained kernels (CDYN_CM_LANES lanes per env x at most CDYN_CM_ENVS envs
per block, the launcher picking the count from the slice; the first is the
default build) and with the phase timing of a solve
(CDYN_CM_PROFILE). Then, one process per build (a process binds one build):
anymal-pid in constraint contact mode at float32, B = 131072, reset and N
steps with zero actions (default 2), and cdyn_rollout_cm timed with CUDA
events on those states; the default build also with one PGS sweep instead of
the configured count (the sweeps' share of the step), the profile build
with the clock64() cycles of each phase of a solve, summed over each group's
lane 0. The default build also times cdyn_period_cm on the same states. With
--against DIR, another checkout of the repo (for example the parent commit,
unpacked with `git archive`) has its cdyn_rollout_cm and cdyn_period_cm
timed the same way in the same call, before the builds here and after them.
With --default-only, only the default build runs (with --against, an A/B of
the default geometry: the other checkout, this one, the other again).
With --models, the default build alone, for each constrained model of the
smoke run (MODELS: anymal-pid in constraint mode on flat and on rough
ground, digit-pid, the ant in constraint mode on flat and on rough ground,
the pendulum; --only NAME,... a subset) at float32, B = 131072: reset and N
steps of zero actions, one more step on each path with the kernels'
arguments taken as the engine passes them, then cdyn_rollout_cm and
cdyn_period_cm timed with CUDA events on them; the other checkout (DIR),
this one, this one, the other again, each in a process of its own. With
--variant DEFINE,... also a build here with those macros (for example
CDYN_CM_ENVS=2), timed in the middle: DIR, this one, the variant, the
variant, this one, DIR.
Prints a line per build and, last, one JSON object of them all.
Needs one card; chip_smoke.py holds the kernels against their plain versions,
this script only times them.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

CANDIDATES = ((8, 4), (8, 2), (8, 8), (4, 8), (16, 2))  # (lanes per env, envs per block)
PROFILE = ("CDYN_CM_PROFILE",)
PHASES = ("kinematics", "active sets", "CRBA | RNEA | rows", "LDL^T factor", "M^-1 solves",
          "A and b", "sweeps", "accelerations")


def defines_of(lanes, envs):
    return (f"CDYN_CM_LANES={lanes}", f"CDYN_CM_ENVS={envs}")


def child(defines, steps, root=None):
    import dataclasses

    if root:  # another checkout: its package, its chip_smoke helpers, its build
        sys.path.insert(0, root)
        os.chdir(root)
    import torch

    import chip_smoke as cs
    from jiminy_torch.engine import solver
    from jiminy_torch.ops import kernels

    lib = kernels.load(defines) if defines else kernels.load()
    dev = torch.device("cuda", 0)
    env = cs._cm_make(dev, torch.float32)
    action = torch.zeros(env.action_size, device=dev)
    st, _ = env.reset(batch_size=cs.B_MAIN)
    for _ in range(steps):
        st, *_ = env.step(st, action)
    block = env.block.name
    ctrl = env.env._component_controllers[block]
    run = env.engine._get_rollout_run(block, ctrl, env.env.n_ctrl_per_step)
    xs = (st.sim.q, st.sim.v, torch.zeros((cs.B_MAIN, env.robot.nmotors), device=dev),
          torch.cat([st.blocks[block].reshape(cs.B_MAIN, -1),
                     cs._cm_solver_row(st.sim, torch.float32)], -1))
    prun = env.engine._get_period_run("rk4")
    pxs = (st.sim.q, st.sim.v,
           torch.cat([st.sim.command, cs._cm_solver_row(st.sim, torch.float32)], -1))
    if root:
        print(json.dumps({"against": root, "ms": cs._time_cuda(lambda: run.kernel(*xs), 2),
                          "ms_period": cs._time_cuda(lambda: prun.kernel(*pxs), 5)}))
        return
    smem, envs, per_sm = run.launch_geometry(dev, torch.float32)
    rec = {"defines": list(defines), "smem_per_env": smem, "envs_per_block": envs,
           "envs_per_sm": per_sm}
    if defines == PROFILE:
        lib.cm_phase_cycles()  # zeroed
        rec["ms"] = cs._time_cuda(lambda: run.kernel(*xs), 1)  # a warm-up launch and a timed one
        cycles = lib.cm_phase_cycles()
        solves = 2 * cs.B_MAIN * run.n_ticks * (4 * run.n_substeps + 1)
        rec["cycles_per_solve"] = sum(cycles) / solves
        rec["phase_share"] = {name: c / sum(cycles) for name, c in zip(PHASES, cycles)}
    else:
        rec["ms"] = cs._time_cuda(lambda: run.kernel(*xs), 2)
        if not defines:
            one = solver.ConstrainedRolloutIntegrator(
                run.cd, run.tau_c, run.cset, dataclasses.replace(run.opts, iter_max=1), run.dt,
                run.n_substeps, run.n_ticks, ctrl, run.integrator, run.imu_frames)
            rec["ms_one_sweep"] = cs._time_cuda(lambda: one.kernel(*xs), 2)
            rec["iter_max"] = run.opts.iter_max
            rec["ms_period"] = cs._time_cuda(lambda: prun.kernel(*pxs), 5)
    print(json.dumps(rec), flush=True)


MODELS = ("anymal-pid", "anymal-pid rough", "digit-pid", "ant", "ant rough", "pendulum")


def models_child(steps, models, root=None, defines=()):
    """Both constrained kernels of each of `models` (of MODELS), timed on the
    arguments the engine hands them after `steps` steps (this checkout with
    the build of `defines`, or `root`)."""
    if root:
        sys.path.insert(0, root)
        os.chdir(root)
    import torch

    import chip_smoke as cs
    from jiminy_torch.engine import solver
    from jiminy_torch.envs import make
    from jiminy_torch.ops import kernels

    kernels.load(defines)
    dev = torch.device("cuda", 0)
    makers = {
        "anymal-pid": lambda: cs._cm_make(dev, torch.float32),
        "anymal-pid rough": lambda: cs._rough_make(dev, torch.float32, constraint=True),
        "ant": lambda: cs._ant_make(dev, torch.float32, constraint=True),
        "ant rough": lambda: cs._ant_make(dev, torch.float32, constraint=True, rough=True),
    }
    calls = {}
    originals = {}
    for cls, key in ((solver.ConstrainedRolloutIntegrator, "rollout"),
                     (solver.ConstrainedPeriodIntegrator, "period")):
        originals[key] = cls.kernel

        def kernel(self, *args, _key=key, **kw):
            calls.setdefault(_key, (self, args, kw))
            return originals[_key](self, *args, **kw)

        cls.kernel = kernel
    out = {}
    for model in models:
        env = makers.get(model, lambda: make(model, device=dev, dtype=torch.float32))()
        action = torch.zeros(env.action_size, device=dev)
        st, _ = env.reset(batch_size=cs.B_MAIN)
        for _ in range(steps):
            st, *_ = env.step(st, action)
        calls.clear()
        env.step(st, action)
        env.use_fused_rollout = False
        env.step(st, action)
        torch.cuda.synchronize()
        rec = {}
        for key, n in (("rollout", 2), ("period", 5)):
            run, args, kw = calls[key]
            rec["ms" if key == "rollout" else "ms_period"] = cs._time_cuda(
                lambda: originals[key](run, *args, **kw), n)
        out[model] = rec
        del env, st
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "defines": list(defines), "models": out}))


def ptxas_line(res, kernel, terrain=False):
    """Registers and stack of `kernel` (float32, the bound and contact rows'
    instance; its flat-ground instance, or with `terrain` its terrain
    instance) from a build's ptxas log."""
    marks = ("IfLb1ELb0E",) if terrain else ("IfE", "IfLb0ELb0E")
    lines = res.ptxas_log.splitlines()
    for i, line in enumerate(lines):
        if ("Compiling entry function" in line and kernel in line
                and any(m in line for m in marks)):
            for nxt in lines[i + 1:i + 6]:
                if "registers" in nxt:
                    return nxt.split("info    :")[-1].strip()
    return "?"


def run_child(steps, defines=(), root=None):
    """One build's record, from a process of its own."""
    extra = ["--against", root] if root else []
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--steps", str(steps), *extra,
                           "--child", *defines], capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        return None
    return json.loads(proc.stdout.strip().splitlines()[-1])


def build_against(root):
    """Build the other checkout's kernels in a process of its own."""
    code = f"import sys; sys.path.insert(0, {root!r}); from jiminy_torch.ops import kernels; kernels.build()"
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, capture_output=True)


def main(argv):
    steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv else 2
    against = os.path.abspath(argv[argv.index("--against") + 1]) if "--against" in argv else None
    models = tuple(argv[argv.index("--only") + 1].split(",")) if "--only" in argv else MODELS
    variant = tuple(argv[argv.index("--variant") + 1].split(",")) if "--variant" in argv else ()
    if "--child" in argv:
        if "--models" in argv:
            models_child(steps, models, against, variant)
        else:
            child(tuple(argv[argv.index("--child") + 1:]), steps, against)
        return 0

    import torch

    import chip_smoke as cs
    from jiminy_torch.ops import kernels

    if not torch.cuda.is_available():
        print("cm_profile: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.nvidia_smi_line()
    if "--models" in argv:
        return models_ab(steps, against, smi, models, variant)
    builds = [()] if "--default-only" in argv else (
        [()] + [defines_of(*g) for g in CANDIDATES[1:]] + [PROFILE])
    with ThreadPoolExecutor(len(builds) + 1) as pool:
        done = pool.submit(build_against, against) if against else None
        results = list(pool.map(lambda d: kernels.build(defines=d), builds))
        if done:
            done.result()
    records, against_ms, against_period_ms = [], [], []

    def time_against():
        rec = run_child(steps, root=against)
        if rec is None:
            return False
        against_ms.append(rec["ms"])
        against_period_ms.append(rec["ms_period"])
        print(f"[cm-profile] cdyn_rollout_cm float32 B={cs.B_MAIN} of {against}: {rec['ms']:.3f} ms, "
              f"cdyn_period_cm {rec['ms_period']:.3f} ms (CUDA events) on {smi}", flush=True)
        return True

    if against and not time_against():
        return 1
    for defines, res in zip(builds, results):
        rec = run_child(steps, defines)
        if rec is None:
            return 1
        geom = CANDIDATES[0] if not defines else (
            tuple(int(d.split("=")[1]) for d in defines) if defines != PROFILE else CANDIDATES[0])
        rec["lanes"], rec["envs_max"] = geom
        rec["ptxas_rollout_cm_f32"] = ptxas_line(res, "cdyn_rollout_cm")
        rec["ptxas_rollout_cm_f32_terrain"] = ptxas_line(res, "cdyn_rollout_cm", terrain=True)
        records.append(rec)
        extra = ""
        if "ms_one_sweep" in rec:
            share = (rec["ms"] - rec["ms_one_sweep"]) / rec["ms"] * rec["iter_max"] / (rec["iter_max"] - 1)
            extra = (f"; with 1 sweep {rec['ms_one_sweep']:.3f} ms: the sweeps take about {share:.1%}"
                     f"; cdyn_period_cm {rec['ms_period']:.3f} ms")
        if "phase_share" in rec:
            split = ", ".join(f"{k} {v:.1%}" for k, v in rec["phase_share"].items())
            extra = f"; {rec['cycles_per_solve']:.0f} cycles per solve and group: {split}"
        print(f"[cm-profile] cdyn_rollout_cm float32 B={cs.B_MAIN} {' '.join(defines) or 'default'} "
              f"({geom[0]} lanes x {rec['envs_per_block']} envs of at most {geom[1]}, "
              f"{rec['envs_per_sm']} envs an SM, {rec['smem_per_env']} B a env; "
              f"{rec['ptxas_rollout_cm_f32']}): {rec['ms']:.3f} ms (CUDA events){extra} on {smi}",
              flush=True)
    if against and not time_against():
        return 1
    out = {"device": smi, "cm_profile": records}
    if against:
        out["against"] = {"root": against, "ms": against_ms, "ms_period": against_period_ms}
    print(json.dumps(out))
    return 0


def models_ab(steps, against, smi, models, variant):
    """The --models A/B: the other checkout, this one, (the variant, the
    variant,) this one, the other."""
    from jiminy_torch.ops import kernels

    with ThreadPoolExecutor(3) as pool:
        done = [pool.submit(build_against, against), pool.submit(kernels.build)]
        if variant:
            done.append(pool.submit(kernels.build, defines=variant))
        for d in done:
            d.result()
    order = [(against, ()), (None, ())] + [(None, variant)] * (2 if variant else 0) + [
        (None, ()), (against, ())]
    runs = []
    for root, defines in order:
        extra = ["--against", root] if root else []
        if defines:
            extra += ["--variant", ",".join(defines)]
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--steps", str(steps),
                               "--models", "--only", ",".join(models), *extra, "--child"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(rec)
        who = root or ("this checkout " + " ".join(defines)).strip()
        for model, t in rec["models"].items():
            print(f"[cm-models] {who} {model}: cdyn_rollout_cm {t['ms']:.3f} ms, "
                  f"cdyn_period_cm {t['ms_period']:.3f} ms (float32, B=131072, CUDA events) on "
                  f"{smi}", flush=True)
    print(json.dumps({"device": smi, "cm_models": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
