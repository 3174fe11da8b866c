#!/usr/bin/env python3
"""Step times of the generic dynamics path on one NVIDIA GPU.

    python3 generic_profile.py [--steps N]

The cartpole and the acrobot step on the generic path (eager torch, no
kernel): every RK4 stage is one `Engine.dynamics_full`. This script times
their env step at float32, B = 131072 and at B = 1, for each formulation of
the small batched products `ops/lie.py::mv` and `mm` (a broadcast multiply
and sum, the package's; torch.matmul; torch.einsum) with the engine's
CUDA-graph replay of a tick on and off, host clock around synchronised
steps after a warm-up step. Prints a line per case and, last, one JSON
object. Needs one card; chip_smoke.py checks the results, this script only
times them.
"""

import json
import sys
import time

B_MAIN = 131072


def _einsum_mv(m, v):
    import torch

    return torch.einsum("...ij,...j->...i", m, v)


def _einsum_mm(a, b):
    import torch

    return torch.einsum("...ij,...jk->...ik", a, b)


def _matmul_mv(m, v):
    import torch

    return torch.matmul(m, v.unsqueeze(-1)).squeeze(-1)


def _matmul_mm(a, b):
    import torch

    return torch.matmul(a, b)


def main(argv):
    import torch

    import chip_smoke as cs
    from jiminy_torch.envs import make
    from jiminy_torch.ops import lie

    if not torch.cuda.is_available():
        print("generic_profile: no CUDA device", file=sys.stderr)
        return 2
    steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv else 1
    smi = cs.nvidia_smi_line()
    dev = torch.device("cuda", 0)
    forms = {"mulsum": (lie.mv, lie.mm), "matmul": (_matmul_mv, _matmul_mm),
             "einsum": (_einsum_mv, _einsum_mm)}
    records = []
    for env_id in ("cartpole", "acrobot"):
        for batch in (B_MAIN, 1):
            for form, (mv, mm) in forms.items():
                for graphs in (True, False):
                    lie.mv, lie.mm = mv, mm
                    env = make(env_id, device=dev)
                    if not graphs:  # every tick's ops launched eagerly
                        env.engine._replay = lambda name, fn, inputs: fn(*inputs)
                    action = torch.zeros(env.action_size, device=dev)
                    st, _ = env.reset(batch_size=batch,
                                      generator=torch.Generator(dev).manual_seed(0))
                    st, *_ = env.step(st, action)  # warm-up (and the graph's capture)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(steps):
                        st, *_ = env.step(st, action)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) / steps * 1e3
                    rec = {"env": env_id, "batch": batch, "form": form, "graphs": graphs,
                           "step_ms": ms, "env_steps_per_s": batch / ms * 1e3}
                    records.append(rec)
                    print(f"[generic-profile] {env_id} float32 B={batch} {form} "
                          f"{'graphs' if graphs else 'eager'}: {ms:.1f} ms a step, "
                          f"{rec['env_steps_per_s']:.1f} env-steps/s (host clock) on {smi}",
                          flush=True)
    lie.mv, lie.mm = forms["mulsum"]
    print(json.dumps({"device": smi, "generic_profile": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
