#!/usr/bin/env python3
"""Launch geometry and phase split of the constrained (PGS) kernels on one
NVIDIA GPU.

    python3 cm_profile.py [--steps N] [--against DIR]

Builds csrc/cdyn.cu at once for each candidate launch geometry of the
constrained kernels (CDYN_CM_LANES lanes per env x CDYN_CM_ENVS envs per
block; the first is the default build) and with the phase timing of a solve
(CDYN_CM_PROFILE). Then, one process per build (a process binds one build):
anymal-pid in constraint contact mode at float32, B = 131072, reset and N
steps with zero actions (default 2), and cdyn_rollout_cm timed with CUDA
events on those states; the default build also with one PGS sweep instead of
the configured count (the sweeps' share of the step), the profile build
with the clock64() cycles of each phase of a solve, summed over each group's
lane 0. With --against DIR, another checkout of the repo (for example the
parent commit, unpacked with `git archive`) has its cdyn_rollout_cm timed
the same way in the same call, before the builds here and after them.
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
    if root:
        print(json.dumps({"against": root, "ms": cs._time_cuda(lambda: run.kernel(*xs), 2)}))
        return
    packed = run.cd.pack(run.tau_c, run.dt, run.imu_frames, dev, torch.float32)
    rec = {"defines": list(defines),
           "smem_per_env": solver.cm_smem_per_env(packed, run.pack(dev, torch.float32),
                                                  torch.float32)}
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
    print(json.dumps(rec), flush=True)


def ptxas_line(res, kernel):
    """Registers and stack of `kernel` (float32) from a build's ptxas log."""
    lines = res.ptxas_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line and "IfE" in line:
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
    if "--child" in argv:
        child(tuple(argv[argv.index("--child") + 1:]), steps, against)
        return 0

    import torch

    import chip_smoke as cs
    from jiminy_torch.ops import kernels

    if not torch.cuda.is_available():
        print("cm_profile: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.nvidia_smi_line()
    builds = [()] + [defines_of(*g) for g in CANDIDATES[1:]] + [PROFILE]
    with ThreadPoolExecutor(len(builds) + 1) as pool:
        done = pool.submit(build_against, against) if against else None
        results = list(pool.map(lambda d: kernels.build(defines=d), builds))
        if done:
            done.result()
    records, against_ms = [], []

    def time_against():
        rec = run_child(steps, root=against)
        if rec is None:
            return False
        against_ms.append(rec["ms"])
        print(f"[cm-profile] cdyn_rollout_cm float32 B={cs.B_MAIN} of {against}: {rec['ms']:.3f} ms "
              f"(CUDA events) on {smi}", flush=True)
        return True

    if against and not time_against():
        return 1
    for defines, res in zip(builds, results):
        rec = run_child(steps, defines)
        if rec is None:
            return 1
        geom = CANDIDATES[0] if not defines else (
            tuple(int(d.split("=")[1]) for d in defines) if defines != PROFILE else CANDIDATES[0])
        rec["lanes"], rec["envs_per_block"] = geom
        rec["ptxas_rollout_cm_f32"] = ptxas_line(res, "cdyn_rollout_cm")
        records.append(rec)
        extra = ""
        if "ms_one_sweep" in rec:
            share = (rec["ms"] - rec["ms_one_sweep"]) / rec["ms"] * rec["iter_max"] / (rec["iter_max"] - 1)
            extra = f"; with 1 sweep {rec['ms_one_sweep']:.3f} ms: the sweeps take about {share:.1%}"
        if "phase_share" in rec:
            split = ", ".join(f"{k} {v:.1%}" for k, v in rec["phase_share"].items())
            extra = f"; {rec['cycles_per_solve']:.0f} cycles per solve and group: {split}"
        print(f"[cm-profile] cdyn_rollout_cm float32 B={cs.B_MAIN} {' '.join(defines) or 'default'} "
              f"({geom[0]} lanes x {geom[1]} envs, {rec['smem_per_env']} B a env; "
              f"{rec['ptxas_rollout_cm_f32']}): {rec['ms']:.3f} ms (CUDA events){extra} on {smi}",
              flush=True)
    if against and not time_against():
        return 1
    out = {"device": smi, "cm_profile": records}
    if against:
        out["against"] = {"root": against, "ms": against_ms}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
