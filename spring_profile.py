#!/usr/bin/env python3
"""Launch geometry, local memory and occupancy of the spring-damper kernels
(cdyn_rollout, cdyn_period) on one NVIDIA GPU.

    python3 spring_profile.py [--steps N] [--against DIR]

Builds csrc/cdyn.cu at once: the default build, one build per candidate
launch geometry of the spring kernels (CDYN_SP_LANES lanes per env x
CDYN_SP_ENVS envs per block) and the occupancy build (CDYN_ACCEL_THREADS=32:
cdyn_accel, one env per thread with its evaluation's working set on the
stack, in blocks of one warp). Then:

- SASS: the LDL / STL instructions (local-memory loads and stores) of each
  function of the default build, from `cuobjdump -sass`, and those of the
  float32 spring kernels by the source line they come from (a `-lineinfo`
  cubin of the same source, `nvdisasm -g`).
- One process per build: anymal-pid at float32, B = 131072, reset and N
  steps with zero actions (default 2); cdyn_rollout and cdyn_period timed
  with CUDA events on those states.
- Occupancy: in the occupancy build's process and the default build's,
  cdyn_accel and cdyn_rollout on the first B_k = 32 k x (number of SMs) of
  those states, k = 1, 2, 4, 8, 16: with one-warp blocks about k warps an
  SM. A warp that takes longer as more warps share its SM (the serial
  kernel, as its stack leaves L1) is held back by memory traffic; one that
  takes as long is held back by the latency of its dependent arithmetic.

With --against DIR, another checkout of the repo (for example the parent
commit, unpacked with `git archive`) is built and timed the same way in the
same call, before the builds here and after them, and its SASS counted.
Prints a line per build and, last, one JSON object of them all. Needs one
card; chip_smoke.py holds the kernels against their plain versions, this
script only times them.
"""

import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

CANDIDATES = ((4, 8), (4, 16), (8, 4), (8, 8), (2, 16), (1, 32))  # (lanes per env, envs a block)
OCCUPANCY = ("CDYN_ACCEL_THREADS=32",)
OCCUPANCY_K = (1, 2, 4, 8, 16)


def defines_of(lanes, envs):
    return (f"CDYN_SP_LANES={lanes}", f"CDYN_SP_ENVS={envs}")


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
        name = next((k for k in ("cdyn_rollout_kernelIf", "cdyn_period_kernelIf") if fn and k in fn),
                    None)
        if name and re.search(r"\b(LDL|STL)(\.\w+)*\b", line):
            per = hits.setdefault(name[:-2], {})
            per[where] = per.get(where, 0) + 1
    return hits


def spring_sass(counts):
    """The spring kernels' entries (and what they call) of `sass_local_counts`."""
    keys = ("rollout", "period", "accel")
    return {f: c for f, c in counts.items() if any(k in f for k in keys) and "_cm" not in f}


def child(defines, steps, root=None):
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
    rec = {"defines": list(defines), "root": root,
           "ms_rollout": cs._time_cuda(lambda: run.kernel(*xs), 3),
           "ms_period": cs._time_cuda(lambda: prun.kernel(q, v, cmd), 5)}
    if not defines or defines == OCCUPANCY:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        tau = eng._compute_efforts(cmd, v)[1].contiguous()
        occ = []
        for k in OCCUPANCY_K:
            b = 32 * k * sms
            sub = tuple(x[:b].contiguous() for x in xs)
            ms_a = cs._time_cuda(lambda: eng._cdyn.accel_kernel(q[:b], v[:b], tau[:b]), 20)
            ms_r = cs._time_cuda(lambda: run.kernel(*sub), 2)
            occ.append({"k": k, "B": b, "ms_accel": ms_a, "ms_rollout": ms_r,
                        "ns_per_env_accel": ms_a * 1e6 / b, "ns_per_env_rollout": ms_r * 1e6 / b})
        rec["occupancy"] = occ
        rec["ns_per_env_accel_full"] = cs._time_cuda(
            lambda: eng._cdyn.accel_kernel(q, v, tau), 20) * 1e6 / cs.B_MAIN
    if not root:
        from jiminy_torch.ops import cdyn

        packed = run.cd.pack(run.tau_c, run.dt, run.imu_frames, dev, torch.float32)
        smem = getattr(cdyn, "sp_smem_per_env", None)
        if smem is not None:
            rec["smem_per_env"] = smem(packed, run.controller.n_cmd, xs[2].shape[1],
                                       xs[3].shape[1], torch.float32)
    print(json.dumps(rec), flush=True)


def ptxas_lines(log, kernels=("cdyn_rollout", "cdyn_period", "cdyn_accel")):
    """{kernel (float32): registers / stack line} from a build's ptxas log."""
    lines, out = log.splitlines(), {}
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line or "IfE" not in line:
            continue
        name = next((k for k in kernels if k + "_kernel" in line), None)
        if name is None or "_cm" in line:
            continue
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
        print("spring_profile: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.nvidia_smi_line()
    builds = [()] + [defines_of(*g) for g in CANDIDATES[1:]] + [OCCUPANCY]
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

    def report(rec, label):
        occ = ""
        if "occupancy" in rec:
            occ = "; occupancy (k warps an SM in one-warp blocks for the accel build): " + ", ".join(
                f"k={o['k']} accel {o['ns_per_env_accel']:.3f} / rollout {o['ns_per_env_rollout']:.1f}"
                f" ns per env" for o in rec["occupancy"])
            occ += f"; accel at B={cs.B_MAIN}: {rec['ns_per_env_accel_full']:.3f} ns per env"
        smem = f", {rec['smem_per_env']} B a env" if "smem_per_env" in rec else ""
        print(f"[sp-profile] {label}{smem}: cdyn_rollout {rec['ms_rollout']:.3f} ms, cdyn_period "
              f"{rec['ms_period']:.3f} ms (float32, B={cs.B_MAIN}, CUDA events){occ} on {smi}",
              flush=True)

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
        if defines and defines != OCCUPANCY:
            rec["lanes"], rec["envs_per_block"] = (int(d.split("=")[1]) for d in defines)
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
