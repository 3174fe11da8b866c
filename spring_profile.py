#!/usr/bin/env python3
"""Launch geometry and local memory of the spring-damper kernels
(cdyn_rollout, cdyn_period, cdyn_accel) on one NVIDIA GPU.

    python3 spring_profile.py [--steps N] [--against DIR [--pairs N]]

Builds csrc/cdyn.cu at once: the default build and one build per candidate
launch geometry (CDYN_SP_LANES lanes per env x CDYN_SP_ENVS envs per block,
cdyn_accel's envs per block CDYN_ACCEL_ENVS set alike; then cdyn_accel alone
at other envs per block). Then:

- SASS: the LDL / STL instructions (local-memory loads and stores) of each
  function of the default build, from `cuobjdump -sass`, and those of the
  float32 spring kernels by the source line they come from (a `-lineinfo`
  cubin of the same source, `nvdisasm -g`).
- The inputs, made once on the card with the default build: anymal-pid at
  float32, B = 131072, reset and N steps with zero actions (default 2), and
  the stage states of a DOPRI trial (the same env under adaptive DOPRI, one
  step from its reset, the inputs of the middle evaluation of its second
  step).
- One process per build: cdyn_rollout and cdyn_period timed with CUDA events
  on the main path's states, cdyn_accel on those states and on the DOPRI
  stage states; then the spring-damper main path's env-steps/s over
  chip_smoke.py's step count (host clock), five times, so that two
  checkouts compare end to end in one call.

With --against DIR, another checkout of the repo (for example the parent
commit, unpacked with `git archive`) is built and timed the same way in the
same call, before the builds here and after them, and its SASS counted.
With --pairs N as well, only the two default builds run: N pairs of
processes, alternating which checkout runs first, for an A/B of the
spring-damper main path in one call.
Prints a line per build and, last, one JSON object of them all. Needs one
card; chip_smoke.py holds the kernels against their plain versions, this
script only times them.
"""

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

CANDIDATES = ((4, 8), (4, 16), (8, 4), (8, 8), (2, 16), (1, 32))  # (lanes per env, envs a block)
ACCEL_ENVS = (4, 8, 32)  # cdyn_accel alone at 4 lanes per env
INPUTS = os.path.join("build", "spring_profile_inputs.pt")
RUNS = 5  # timed runs of the spring-damper main path in each build's process


def defines_of(lanes, envs):
    return (f"CDYN_SP_LANES={lanes}", f"CDYN_SP_ENVS={envs}", f"CDYN_ACCEL_ENVS={envs}")


def sass_local_counts(lib_path):
    """{function: [LDL count, STL count]} of every function of a library."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                         check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts.setdefault(fn, [0, 0])
        elif fn is not None:
            if re.search(r"\bLDL(\.\w+)*\b", line):
                counts[fn][0] += 1
            if re.search(r"\bSTL(\.\w+)*\b", line):
                counts[fn][1] += 1
    return counts


def sass_local_lines():
    """{kernel: {"file:line": LDL and STL count}} of the float32 spring
    kernels, from a -lineinfo cubin of csrc/cdyn.cu (the default geometry)."""
    from jiminy_torch.ops import kernels

    cuda = os.path.dirname(os.path.dirname(kernels.nvcc_path()))
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cubin = str(kernels.BUILD_DIR / "cdyn_lineinfo.cubin")
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([kernels.nvcc_path(), *flags, "-lineinfo", "-cubin", "-I", str(kernels.CSRC_DIR),
                    "-o", cubin, str(kernels.SOURCE)], check=True, capture_output=True)
    out = subprocess.run([os.path.join(cuda, "bin", "nvdisasm"), "-g", "-c", cubin],
                         capture_output=True, text=True, check=True).stdout
    hits, fn, where = {}, None, None
    for line in out.splitlines():
        m = re.search(r"\.text\.(\S+?):?\s*$", line) if line.lstrip().startswith(".text") else None
        m = m or re.search(r"\.section\s+\.text\.([^,\s]+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r'//## File "([^"]+)", line (\d+)', line)
        if m:
            where = f"{os.path.basename(m.group(1))}:{m.group(2)}"
            continue
        name = next((k for k in ("cdyn_rollout_kernelIf", "cdyn_period_kernelIf",
                                  "cdyn_accel_kernelIf") if fn and k in fn), None)
        if name and re.search(r"\b(LDL|STL)(\.\w+)*\b", line):
            per = hits.setdefault(name[:-2], {})
            per[where] = per.get(where, 0) + 1
    return hits


def spring_sass(counts):
    """The spring kernels' entries (and what they call) of `sass_local_counts`."""
    keys = ("rollout", "period", "accel")
    return {f: c for f, c in counts.items() if any(k in f for k in keys) and "_cm" not in f}


def make_inputs(steps):
    """The main path's states and a DOPRI trial's stage states on the card
    (float32, B = B_MAIN), saved for every build's process."""
    import torch

    import chip_smoke as cs
    from jiminy_torch.envs import make
    from jiminy_torch.testing import dopri_options

    dev = torch.device("cuda", 0)
    env = make("anymal-pid", device=dev)
    action = torch.zeros(env.action_size, device=dev)
    st, _ = env.reset(batch_size=cs.B_MAIN)
    for _ in range(steps):
        st, *_ = env.step(st, action)
    eng = env.env.engine
    main = (st.sim.q, st.sim.v, eng._compute_efforts(st.sim.command, st.sim.v)[1])
    denv = make("anymal-pid", device=dev, options=dopri_options(env.engine.options))
    dst, _ = denv.reset(batch_size=cs.B_MAIN)
    dst, *_ = denv.step(dst, action)
    cd, seen = denv.engine._cdyn, []
    cd.accel = lambda q, v, tau: seen.append((q, v, tau)) or type(cd).accel(cd, q, v, tau)
    denv.step(dst, action)
    del cd.accel
    stage = seen[len(seen) // 2]
    os.makedirs(os.path.dirname(INPUTS), exist_ok=True)
    torch.save({"main": [x.contiguous().cpu() for x in main],
                "stage": [x.contiguous().cpu() for x in stage], "commands": len(seen)}, INPUTS)


def child(defines, steps, root=None):
    inputs = os.path.abspath(INPUTS)
    if root:  # another checkout: its package, its chip_smoke helpers, its build
        sys.path.insert(0, root)
        os.chdir(root)
    import torch

    import chip_smoke as cs
    from jiminy_torch.envs import make
    from jiminy_torch.ops import kernels

    kernels.load(defines) if defines else kernels.load()
    dev = torch.device("cuda", 0)
    env = make("anymal-pid", device=dev)  # float32
    action = torch.zeros(env.action_size, device=dev)
    st, _ = env.reset(batch_size=cs.B_MAIN)
    for _ in range(steps):
        st, *_ = env.step(st, action)
    eng = env.env.engine
    block = env.block.name
    ctrl = env.env._component_controllers[block]
    run = eng._get_rollout_run(block, ctrl, env.env.n_ctrl_per_step)
    prun = eng._get_period_run("rk4")
    q, v = st.sim.q.contiguous(), st.sim.v.contiguous()
    cmd = st.sim.command.contiguous()
    xs = (q, v, torch.zeros((cs.B_MAIN, env.robot.nmotors), device=dev),
          st.blocks[block].reshape(cs.B_MAIN, -1).contiguous())
    saved = torch.load(inputs)
    main, stage = ([x.to(dev) for x in saved[k]] for k in ("main", "stage"))
    rec = {"defines": list(defines), "root": root,
           "ms_rollout": cs._time_cuda(lambda: run.kernel(*xs), 3),
           "ms_period": cs._time_cuda(lambda: prun.kernel(q, v, cmd), 5),
           "ms_accel_main": cs._time_cuda(lambda: eng._cdyn.accel_kernel(*main), 20),
           "ms_accel_stage": cs._time_cuda(lambda: eng._cdyn.accel_kernel(*stage), 20)}
    # The spring-damper main path end to end, as chip_smoke.py times it,
    # RUNS times over (host clock; the median is reported)
    rec["env_steps_per_s"] = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(cs.N_STEPS):
            st, *_ = env.step(st, action)
        torch.cuda.synchronize()
        rec["env_steps_per_s"].append(cs.B_MAIN * cs.N_STEPS / (time.perf_counter() - t0))
    if not root:
        from jiminy_torch.ops import cdyn

        packed = run.cd.pack(run.tau_c, run.dt, run.imu_frames, dev, torch.float32)
        rec["smem_per_env"] = cdyn.sp_smem_per_env(packed, run.controller.n_cmd, xs[2].shape[1],
                                                   xs[3].shape[1], torch.float32)
        rec["accel_smem_per_env"] = cdyn.accel_smem_per_env(packed, torch.float32)
        c = packed.counts
        rec["accel_geometry"] = kernels.load().accel_smem_bytes(c["nj"], c["nq"], c["nv"],
                                                                c["nc"], 4)[1:]
        # The four struct-of-arrays copies a (n, B) kernel would need a call
        # (three inputs, one output), which cdyn_accel's (B, n) rows avoid
        out = torch.empty((c["nv"], cs.B_MAIN), device=dev)
        rec["ms_accel_soa_copies"] = cs._time_cuda(
            lambda: [x.t().contiguous() for x in (*main, out)], 20)
    print(json.dumps(rec), flush=True)


def ptxas_lines(log, kernels=("cdyn_rollout", "cdyn_period", "cdyn_accel")):
    """{kernel (float32): registers / stack line} from a build's ptxas log:
    the flat-ground instance under the kernel's name (a build before the
    terrain instances has only that one), the terrain instance under
    "<kernel> (terrain)", cdyn_accel's SPHERICAL instances with " (spherical)"
    after either."""
    lines, out = log.splitlines(), {}
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        terrain = "IfLb1E" in line
        if not terrain and "IfE" not in line and "IfLb0E" not in line:
            continue
        name = next((k for k in kernels if k + "_kernel" in line), None)
        if name is None or "_cm" in line:
            continue
        name = name + " (terrain)" if terrain else name
        if re.search(r"_kernelI[fd]Lb[01]ELb1E", line):  # cdyn_accel's SPHERICAL instance
            name += " (spherical)"
        for nxt in lines[i + 1:i + 6]:
            if "registers" in nxt or "stack frame" in nxt:
                out.setdefault(name, []).append(nxt.split("info    :")[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


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
    """Build the other checkout's kernels in a process of its own: (library, ptxas log)."""
    code = (f"import sys, json; sys.path.insert(0, {root!r}); from jiminy_torch.ops import kernels; "
            "r = kernels.build(); print(json.dumps([str(r.path), r.ptxas_log]))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, check=True, capture_output=True,
                          text=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def run_pairs(pairs, steps, against, out, report, smi):
    """`pairs` pairs of processes, the other checkout's default build and
    this one's, alternating which runs first; the spring-damper env-steps/s
    of each process is the median of its RUNS runs."""
    sides = {"parent": [], "change": []}
    for i in range(pairs):
        for side in ("parent", "change") if i % 2 == 0 else ("change", "parent"):
            rec = run_child(steps, root=against if side == "parent" else None)
            if rec is None:
                return 1
            sides[side].append(rec)
            report(rec, f"pair {i + 1}, {side}")
    med = {k: [statistics.median(r["env_steps_per_s"]) for r in v] for k, v in sides.items()}
    ahead = sum(c > p for p, c in zip(med["parent"], med["change"]))

    def summary(xs):
        q1, q2, q3 = statistics.quantiles(xs, n=4)
        return f"{q2:.1f} (quartiles {q1:.1f}-{q3:.1f})"

    print(f"[sp-profile] {pairs} pairs, alternating: spring-damper env-steps/s, the median of the "
          f"processes' medians: {against} {summary(med['parent'])}, this checkout "
          f"{summary(med['change'])}; this checkout ahead in {ahead} of {pairs} pairs; "
          f"cdyn_rollout {statistics.median(r['ms_rollout'] for r in sides['parent']):.3f} / "
          f"{statistics.median(r['ms_rollout'] for r in sides['change']):.3f} ms on {smi}",
          flush=True)
    out["pairs"] = sides
    with open(os.path.join("chiprun_out", "spring_profile_pairs.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


def main(argv):
    steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv else 2
    against = os.path.abspath(argv[argv.index("--against") + 1]) if "--against" in argv else None
    pairs = int(argv[argv.index("--pairs") + 1]) if "--pairs" in argv else 0
    if pairs and not against:
        print("spring_profile: --pairs needs --against", file=sys.stderr)
        return 2
    if "--child" in argv:
        child(tuple(argv[argv.index("--child") + 1:]), steps, against)
        return 0
    if "--inputs" in argv:
        make_inputs(steps)
        return 0

    import torch

    import chip_smoke as cs
    from jiminy_torch.ops import kernels

    if not torch.cuda.is_available():
        print("spring_profile: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.nvidia_smi_line()
    builds = [()] if pairs else ([()] + [defines_of(*g) for g in CANDIDATES[1:]]
                                 + [(f"CDYN_ACCEL_ENVS={e}",) for e in ACCEL_ENVS])
    os.makedirs("chiprun_out", exist_ok=True)
    with ThreadPoolExecutor(len(builds) + 2) as pool:
        done = pool.submit(build_against, against) if against else None
        lines = pool.submit(sass_local_lines)
        results = list(pool.map(lambda d: kernels.build(defines=d), builds))
        against_build = done.result() if done else None
        local_lines = lines.result()
    out = {"device": smi, "builds": []}
    sass = spring_sass(sass_local_counts(results[0].path))
    out["sass_local"] = sass
    out["sass_local_lines"] = local_lines
    print(f"[sp-profile] default build SASS, LDL / STL per function: {sass}", flush=True)
    print(f"[sp-profile] float32 spring kernels' LDL / STL by source line: {local_lines}", flush=True)
    print(f"[sp-profile] default build ptxas (float32): {ptxas_lines(results[0].ptxas_log)}",
          flush=True)
    if against:
        lib, log = against_build
        out["against"] = {"root": against, "sass_local": spring_sass(sass_local_counts(lib)),
                          "ptxas": ptxas_lines(log), "records": []}
        print(f"[sp-profile] {against} SASS, LDL / STL per function: "
              f"{out['against']['sass_local']}; ptxas (float32): {out['against']['ptxas']}",
              flush=True)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--steps", str(steps),
                           "--inputs"], capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        return 1

    def report(rec, label):
        smem = ""
        if "smem_per_env" in rec:
            smem = (f", {rec['smem_per_env']} B a env (rollout), {rec['accel_smem_per_env']} B "
                    f"(accel, {rec['accel_geometry'][0]} lanes x {rec['accel_geometry'][1]} envs; "
                    f"the (n, B) copies it avoids {rec['ms_accel_soa_copies']:.4f} ms a call)")
        print(f"[sp-profile] {label}{smem}: cdyn_rollout {rec['ms_rollout']:.3f} ms, cdyn_period "
              f"{rec['ms_period']:.3f} ms, cdyn_accel {rec['ms_accel_main']:.4f} ms on the main "
              f"path's states / {rec['ms_accel_stage']:.4f} ms on DOPRI stage states (float32, "
              f"B={cs.B_MAIN}, CUDA events); spring-damper "
              f"{statistics.median(rec['env_steps_per_s']):.1f} env-steps/s (median of "
              f"{len(rec['env_steps_per_s'])} runs of {cs.N_STEPS} steps, host clock; "
              f"{min(rec['env_steps_per_s']):.1f}-{max(rec['env_steps_per_s']):.1f}) on {smi}",
              flush=True)

    if pairs:
        return run_pairs(pairs, steps, against, out, report, smi)

    def time_against():
        rec = run_child(steps, root=against)
        if rec is None:
            return False
        out["against"]["records"].append(rec)
        report(rec, f"{against} (default build)")
        return True

    if against and not time_against():
        return 1
    for defines, res in zip(builds, results):
        rec = run_child(steps, defines)
        if rec is None:
            return 1
        rec["ptxas"] = ptxas_lines(res.ptxas_log)
        out["builds"].append(rec)
        report(rec, " ".join(defines) or "default build")
    if against and not time_against():
        return 1
    with open(os.path.join("chiprun_out", "spring_profile.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
