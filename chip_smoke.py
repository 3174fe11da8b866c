#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (jiminy_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Device: the card from nvidia-smi and torch; no CUDA device -> exit 2.
2. Build: nvcc builds csrc/cdyn.cu for sm_90a, its parts an nvcc each, all
   at once, then linked; the -Xptxas -v summary.
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
   split into kernel and glue. Then N_PERIODS_DOPRI_F64 period from the standing robot, its
   velocities perturbed, at float64, B=256, through the kernel and through
   `accel_plain`: the same trials, q, v and a within 1e-9.
6. The three spring kernels at the main path's shapes (B=131072), one
   function for each robot (`phase_kernel_records`): float32 on the main
   path's own states, timed (CUDA events) beside its plain version (cdyn_accel
   also on DOPRI's stage states), TOL's float32 measure printed beside a
   one-ulp witness; float64 on the same states, every column within 1e-9 in
   every env, and a zeroed output refused; float64 and float32 on perturbed
   states (not at equilibrium), as in phase 3 (the rollout is let stray
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
   (the plain constrained solve, timed), N_STEPS_CM steps with zero actions through
   cdyn_rollout_cm (launch counts set to 0 before, read after), then the
   per-period path through cdyn_period_cm; physics checks on the final
   state (all finite, none terminated, the feet carry the robot's weight
   within 5 %, joints within their limits, multipliers inside their boxes
   and friction cones).
8. The constrained kernels at B=131072: float32 on the main path's states,
   timed over the whole launch and over the checks' cut; float64 on the main path's
   states and float64 and float32 on states with active rows
   (`constrained_inputs`), with every row and with no row active, and at a
   batch one env short (the last block part-filled), at 2 ticks x 2
   substeps (a plain constrained step is millions of eager launches; the
   plain version is timed over that cut, `plain_ms` null), per
   column as in phase 3; and witnesses that the check fails for a zeroed
   multiplier column and for a solver stopped after one sweep. Ops are
   counted on the plain version per scalar element at B=1 on a main-path
   state, those with an exactly-zero operand (structural or inactive-row
   zeros) folded away.

9. Atlas golden rows: atlas-reduced-pid at float64 through the kernels, both
   paths, ATLAS_GOLDEN_ROWS rows of tests/goldens/atlas-reduced-pid.csv.
   The standing humanoid amplifies a difference tenfold a controller tick
   once its feet touch down, so env 0 is held to GOLDEN_REACH times the
   spread of two witnesses started with the base height one ulp up and down
   (envs 1, 2), plus GOLDEN_ATOL, row by row.
10. Atlas main path: make("atlas-pid") (31 joints, nv 36, 30 motors, 12
   contact points; 16 controller ticks of 5 RK4 substeps a step) at float32
   on the card, launch counts set to 0, batched reset at B=131072, a warm-up
   step and N_STEPS_ATLAS steps of zero actions, counts read; env-steps/s,
   the cdyn_rollout launch (CUDA events), the share of terminated envs;
   then one step of the per-period path.
11. The three spring kernels on atlas-pid's path states, as in phase 6 at
   B=131072, each rollout held to its plain version over ATLAS_CHECK_TICKS
   controller ticks (one-ulp differences grow tenfold a tick on the standing
   humanoid) and each period over ATLAS_CHECK_SUBSTEPS substeps; a whole
   plain launch is not run: those records have `plain_ms` null, and the
   kernel and the plain version timed over the cut. Their records join the
   kernel line with `"model": "atlas-pid"`.
12. Toy golden rows: make("cartpole"), "acrobot" and "pendulum" at float64,
   B=1, on the card, every row of tests/goldens/<toy>.csv from jiminy_tpu's
   initial states (tests/goldens_torch/toy_initial_states.json) with the
   golden actions, each row within TOY_GOLDEN_ATOL; the pendulum on both
   paths, through cdyn_rollout_cm once a step and cdyn_period_cm once a
   period (launch counts); the cartpole and the acrobot launch no kernel
   (the generic path, whose per-period path is its default path).
13. Toy main path: each toy at float32, B=131072 (initial states from a
   seeded torch.Generator), a warm-up step, launch counts to 0,
   N_STEPS_TOYS steps of zero actions, counts read: env-steps/s, all
   finite, none terminated; the pendulum also its per-period path. Beside
   phase 16: one step of anymal-pid on the generic path
   (use_fast_dynamics=False) at float64 on B_GENERIC_F64 envs against the
   kernel path from the same states, every column within GENERIC_TOL.
14. The pendulum's constrained kernels at B=131072 at their full tick and
   substep counts: float32 on the main path's states, timed (CUDA events)
   beside the plain version; float64 on the main path's states, perturbed
   states (a quarter past the bound), every row and no row active, and one
   env short, every column within TOL; a zeroed acceleration and zeroed
   multipliers refused; shared memory and envs an SM; records join the
   kernels line with `"model": "pendulum"`.
15. PPO on anymal-pid at full width (jiminy_tpu's benchmarks/ppo_train.py
   shape at 4096 envs): FlattenObservation(make("anymal-pid", horizon=1000)),
   float32, PPO_ANYMAL, a warm-up iteration, launch counts to 0,
   N_ITERS_PPO iterations, counts read: exactly one cdyn_rollout an env step
   and one cdyn_accel an auto-reset (the whole batch is reset every step),
   nothing else. Training env-steps/s (host clock), the iteration's split
   into rollout, GAE and update and a rollout step's into the policy, the
   env step, the auto-reset's reset and pick (CUDA events on make_train's
   spans in the timed iterations), the auto-reset's and the policy
   forward's shares of a rollout step; parameters and metrics
   finite, parameters moved, approx_kl_pos in [0, 1), no env diverged.
16. PPO learns the cartpole (jiminy_tpu's test_ppo_learns_cartpole whole,
   float64 as that test runs, seed 42): late mean_done below early, the
   episode return tracking its length within 5, lengths growing, 5 greedy
   episodes averaging over 100 steps. It runs from the start in a process
   of its own on the card (the cartpole's generic path launches no kernel),
   beside the build and the phases that time nothing (3, 9, 12, 18 (a) and
   (b), 20 and the ant's rough ground of 23), which run first; every other
   phase runs after it, alone on the card.
17. One train_step on the card against the CPU at float64, from the same
   parameters, initial states and draws: the cartpole (8 envs x 8 steps,
   every env auto-reset inside the rollout) and anymal-pid (16 envs x 2
   steps, horizon 1 so every env auto-resets at every step, through
   cdyn_rollout and cdyn_accel); the auto-reset's states drawn on the CPU
   and given to both; the trajectory, the metrics and the carried state
   within PPO_F64_TOL of their scale, parameters and Adam moments within
   PPO_PARAM_ULPS float32 ulps.
18. Terrain: anymal-pid on rough ground (`testing.rough_ground`, jiminy_tpu's
   own fused-terrain case: 4-octave Perlin plus stairs, summed), every
   kernel's terrain instance (the ground's packed program evaluated per
   contact in device code). (a) The five kernels against their plain
   versions on states spread over a 20 m x 20 m square: cdyn_accel and the
   constrained pair at B=4096 (the pair at phase 8's 2 ticks x 2 substeps),
   the spring period and rollout at phase 3's B=64 and cut; float64 within
   1e-9 on every column, float32 within TOL. (b) Witnesses that the check
   can fail: the flat cdyn_accel on the same states misses the rough plain
   version beyond TOL, and at least ROUGH_TILT_SHARE of the touching
   contacts meet a ground more than ROUGH_TILT_RAD off vertical. (c) The
   main path on the ground at float32, B=131072, in both contact modes:
   reset, the bases spread over the square from a seeded torch.Generator and
   lifted by the largest ground height under their feet plus 1 mm, reset
   there, launch counts set to 0, N_STEPS_ROUGH steps through cdyn_rollout
   and N_STEPS_ROUGH_CM through cdyn_rollout_cm (one launch a step, nothing
   else), counts read, env-steps/s, all finite, the terminated share
   reported (not gated); then each mode's per-period path one step. (d)
   Records with `"ground": "rough"`: each kernel timed (CUDA events) on the
   rough main path's states beside its flat time, and over ROUGH_CUT (one
   substep of the periods, one tick of the rollouts; `plain_ms` null)
   beside its plain version over the same cut (host clock), the bound
   from the flat plain version's ops plus the terrain branch's, counted on
   the plain version, for every contact evaluation.
19. Digit main path: make("digit-pid") (nq 27, nv 26, 20 motors, 2 pushrod
   loop rows beside 8 spring-damper toe contacts and 20 penalty bounds; 16
   ticks of 5 RK4 substeps a step) at float32, B=131072: reset, a warm-up
   step, launch counts to 0, N_STEPS_DIGIT steps of zero actions, counts
   read (one cdyn_rollout_cm a step and nothing else): env-steps/s, every
   pushrod within PUSHROD_TOL of its length, all finite, no standing env
   below base_height_min; then one step of the per-period path (one
   cdyn_period_cm a period). The two kernels on the main path's states
   (`phase_cm_records`, as every constrained model of phases 23 and 25;
   after phase 23, the op count running in a worker meanwhile):
   float32 timed (CUDA events) beside the plain version (host clock; the
   period over one substep, the rollout over DIGIT_PLAIN_TICKS tick, their
   records' `plain_ms` null: a whole plain step is minutes of eager
   launches), their distance printed beside a one-ulp witness and, where
   float64 runs the same launch, the float32 kernel's and plain version's
   distances to the float64 plain version; the period's substep at float64
   one env short, every column within 1e-9, zeroed multipliers and one PGS
   sweep refused (phase 20 holds the whole period at float64); ops
   counted on the plain version (in a worker process), bytes, bound,
   registers, shared memory and envs an SM; records join the kernels line
   with `"model": "digit-pid"`.
20. Beside phase 16, in a card-lane process: the constrained kernels at
   B_LOOP_CHECK on `testing.loop_inputs` states: digit-pid and jiminy_tpu's Cassie-shaped four-bar with a foot
   and a bound, each on flat and rough ground (both instances), both
   kernels; float64 within 1e-9, the four-bar and the flat Digit over a
   whole period and LOOP_TICKS whole ticks (the Digit's zeroed loop
   multipliers and one PGS sweep refused), the rest at
   LOOP_TICKS x LOOP_SUBSTEPS (on rough ground the flat plain outputs must
   differ); float32 within TOL at LOOP_TICKS x LOOP_SUBSTEPS. The
   procedural Cassie (phase 27) on flat ground as the rest, at float64.
21. Cassie: every row of tests/goldens/cassie-pid.csv at float64, B=1, on
   the generic path (continuous ankles; a CUDA graph a tick, no kernel)
   within CASSIE_GOLDEN_ATOL (run from the start by a process of its own on
   the card, as phase 16: it launches no kernel and times nothing); cassie-pid at float32, B=B_CASSIE, a warm-up
   and N_STEPS_CASSIE steps (env-steps/s; no kernel runs), the pushrods
   within PUSHROD_TOL.

22. Ant main path: make("ant") (nq 15, nv 14, 8 motors taking torques, 9
   sphere contacts: the torso's of radius 0.25 m, two on each foot of 0.08
   m; 10 ticks of 5 RK4 substeps a step) at float32, B=131072: launch
   counts to 0, reset (cdyn_accel), a warm-up step and N_STEPS_ANT steps of
   zero actions, counts read (one cdyn_rollout a step, one cdyn_accel at
   the reset, nothing else): env-steps/s, all finite, no standing ant
   terminated; then one step of the per-period path. The three spring
   kernels through `phase_kernel_records` as for the Atlas, the rollout
   over ANT_CHECK_TICKS ticks: the first launches of their radius branch.
23. The ant in constraint contact mode (the C++ reference's
   ant_options.toml: 36 sphere rows, the extended body), the same main path
   through cdyn_rollout_cm (the reset is the plain solve, timed) and
   cdyn_period_cm, phase 7's physics checks with every limited joint held;
   the two kernels on the main path's states as the Digit's (the rollout
   over ANT_CM_TICKS ticks), float64 one env short within 1e-9 with zeroed
   multipliers and one PGS sweep refused; then the ant with its
   bounds as rows too (44 rows) as in phase 25. Then the terrain instance
   with sphere radii on rough ground at B=B_ANT_ROUGH_CHECK, float64, the
   whole period and one tick of the rollout, the flat instance on the same
   states refused.
24. The rolling ball (jiminy_tpu's tests/test_rolling.py: a free sphere of
   radius 0.2 m with a sphere or a wheel rolling constraint, 3 rows): B=131072
   at float32, N_STEPS_BALL steps of 1 ms through cdyn_period_cm (one launch
   a step, nothing else), no slip within 1e-4 m/s, the height within 1 mm,
   the ball travelled; beside phase 16, cdyn_period_cm and its plain
   version at float64 over N_STEPS_BALL_CHECK periods at B=B_BALL_CHECK, q,
   v and the multipliers within 1e-9.
25. The Atlas in constraint mode (`testing.constraint_mode_options`: ground
   contacts and joint bounds as PGS rows): atlas-pid (78 rows, nv 36) and
   atlas-reduced-pid (60 rows), their main paths run after phase 11 and
   their records after phase 23 (their op counts, minutes on the CPU, run
   in a worker meanwhile), and the ant with its bounds as rows (44 rows),
   its main path before phase 22, its records after the Atlas's; each at
   float32, B=B_CM_WIDE
   (the models' full width, the batch cut so that the phase fits): launch
   counts to 0, the reset (the plain constrained solve, timed), a warm-up
   step and N_STEPS_CM_WIDE steps of zero actions through make(...).step,
   counts read (one cdyn_rollout_cm a step, nothing else), env-steps/s,
   phase 7's physics checks; one step of the per-period path (Engine.step:
   one cdyn_period_cm a controller period, nothing else). Both kernels
   through `phase_cm_records`: float32 timed (CUDA events) over the whole
   launch and, beside the plain version, over CM_WIDE_CUT (one substep of
   the period, one tick of one substep of the rollout; `plain_ms` null);
   on the main path's states printed beside a one-ulp witness and beside
   the float32 plain version's distance to the float64 one; float64 one env
   short over that cut within 1e-9, zeroed multipliers and one PGS sweep
   refused; `constrained_inputs` states at B_CM_ROWS (a quarter past a
   bound, every row active, no row active) after the main path's envs in
   the same calls (one plain call a dtype and kernel), float64 within 1e-9
   (every row active, more than CM_REG_ROWS; none active) and the perturbed
   ones at float32 within TOL. Ops (in a worker), bytes, bound, registers,
   bytes an env, envs a block and an SM; records join the kernels line with
   `"model": "... (constraint mode ...)"`.

26. The flexible ANYmal (`make("anymal-pid", flexible=True)`: a spherical
   flexibility joint before each knee, nq 35, nv 30), stage by stage: every
   RK4 stage one launch of cdyn_accel's SPHERICAL instance, a tick a CUDA
   graph. float32, B=131072: the reset (1 launch), a warm-up step and
   N_STEPS_FLEX steps (168 launches a step, nothing else), env-steps/s and
   cdyn_accel's share of a step; RK4 at 1 ms diverges on the flexibility's
   damped mode as in jiminy_tpu (reported, not held); with
   `testing.resolving_options` N_PERIODS_FLEX_RESOLVED periods stand and
   bend the flexibility joints. cdyn_accel against its plain version at
   float64 within 1e-9 on the reset states, the resolved run's and
   `flexible_states` (random and near-identity quaternions), one env short
   too; float32 by TOL's rule; its record with `"model": "anymal-pid
   (flexible)"`.

27. The procedural look-alikes (`procedural=True`). make("cassie-pid",
   procedural=True) (nq 19, nv 18, 10 motors: no continuous joint, so its
   2 pushrod loop rows, 4 spring-damper toes and 10 penalty bounds take the
   constrained kernels' extended body, where the URDF Cassie takes the
   generic path) as the Digit in phase 19: float32, B=131072, reset, a
   warm-up, N_STEPS_DIGIT steps (one cdyn_rollout_cm a step, nothing else),
   env-steps/s, the pushrods within PUSHROD_TOL, finite (the stance
   reported); one per-period step; the two kernels through
   `phase_cm_records` over CM_WIDE_CUT (the rollout at float64 on the main
   path's states within 1e-9), its perturbed `loop_inputs` states
   in phase 20's loop checks. Beside phase 16 (card lane): the procedural atlas-pid,
   digit-pid and ant at float64, B=B_PROC_CHECK, a reset and a step through
   their main path (launch counts read), each kernel of the path against
   its plain version on the step's states over PROC_CUT within 1e-9.
28. The forest (`MultiRobotEngine`, no coupling: the ANYmal, its FREE root
   joint 0, and the acrobot; two joints at depth 0) in each contact mode
   (anymal-pid's options: cdyn_period; constraint mode: cdyn_period_cm),
   float32, B=131072: reset, N_PERIODS_FOREST periods (the kernel once a
   period, nothing else), the kernel timed beside its plain version; beside
   phase 16 (card lane), at float64, B=B_FOREST_CHECK, the forest against
   the two robots each stepped by an engine of its own within FOREST_TOL of
   each column's scale and the kernel against its plain version over one
   substep within 1e-9 on the states they reached; records with
   `"model": "forest: ..."`.
29. Beside phase 16 (card lane; its times on the host clock there):
   couplings and pairs on the generic path: two ANYmals with a
   viscoelastic coupling between their bases and a foot-foot collision
   pair, B=B_COUPLED, N_PERIODS_COUPLED periods (eager, no kernel), the net
   world force of each coupling (and the pair's net torque) zero within
   COUPLING_TOL of its scale at float64; atlas-reduced-pid with a box-box
   pair between its feet, B=B_COUPLED, two ticks (the CUDA graph's capture, then
   a replay), ms a tick, no kernel, the feet apart.

The op and call counts (phases 5, 6, 8, 11, 18, 19, 22, 23, 24, 25, 26, 27
and 28) and phase 17's CPU train_steps run on the CPU in three worker
processes beside the card's phases (those that need no main path's state
from the start). Two processes on the card run phase 16 and, beside it, the
Cassie golden and then `phase_lane_checks` (phases 20, 27 and 28's checks
and phase 29); the main process's checks that time nothing run beside
them, its timed phases after them, alone on the card. Every process the
script starts ends before it exits. The plain versions of the period and
rollout integrators run with their substeps replayed from CUDA graphs
(`replayed`: a substep's first call of an input shape eager, the second
captured, later ones replayed): the same torch kernels on the same inputs,
bit for bit, without the host's launch overhead; `plain_ms` is such a
call's host-clocked time, the capture included.
The last two lines are the `{"kernels": [...]}` record and the device line.
"""

import contextlib
import dataclasses
import json
import math
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
GOLDEN_REACH = 5.0  # atlas golden rows: times the one-ulp witnesses' spread
ATLAS_GOLDEN_ROWS = 10
N_STEPS_ATLAS = 3  # atlas-pid main path
ATLAS_CHECK_TICKS = 1  # atlas rollouts held to their plain version: controller ticks
ATLAS_CHECK_SUBSTEPS = 1  # atlas periods held to their plain version: substeps (of 5)
N_STEPS_CM = 10  # constrained main path (the robot settles within some 10 steps)
N_STEPS_DOPRI = 2  # DOPRI main path
B_DOPRI_F64 = 256  # DOPRI kernel-vs-plain periods
N_PERIODS_DOPRI_F64 = 1
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


def waited(fut, what):
    """`fut`'s result (a worker's count), logged with the time the phase
    waited on it where that was over half a second."""
    t0 = time.perf_counter()
    out = fut.result()
    if time.perf_counter() - t0 > 0.5:
        log(f"[wait] {time.perf_counter() - t0:.1f} s for {what}")
    return out


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


def _step_controller(env):
    """(the base env, the rollout's controller key, its component
    controller, its carry of a state `st`): a pipeline's PD block, or for a
    plain env (the ant) the zero-order hold of its torque actions."""
    import torch

    from jiminy_torch.ops import cdyn

    block = getattr(env, "block", None)
    if block is None:
        ctrl = env._component_controllers.setdefault("zoh", cdyn.ZOHPassThrough(env.robot.nmotors))
        return env, "zoh", ctrl, lambda st: st.sim.q.new_zeros(st.sim.q.shape[:-1] + (0,))
    base = env.env
    ctrl = base._component_controllers.get(block.name) or block.component_controller(base)
    return base, block.name, ctrl, lambda st: st.blocks[block.name].reshape(
        st.sim.q.shape[:-1] + (-1,)).contiguous()


def plain_op_counts(env_cpu, prune_zeros):
    """Ops per env of one accel evaluation, one 5-substep period and one
    8-tick rollout, counted on the CPU at B=1 (the rollout from three short
    runs: ops = final + ticks * (controller + substeps * substep)). Without
    `prune_zeros` this is the generic formulation that the kernels run (the
    model's constants read at run time, zeros included); with it, the work
    left once the model's structural zeros are folded away."""
    import torch

    from jiminy_torch.testing import perturbed_states

    base, _, ctrl, _ = _step_controller(env_cpu)
    eng = base.engine
    q, v, tau = perturbed_states(env_cpu, 1, seed=9)
    nm = env_cpu.robot.nmotors
    cmd = torch.zeros((1, nm), dtype=q.dtype)

    def count(fn):
        return count_ops(fn, prune_zeros)

    accel = count(lambda: eng._cdyn.accel_plain(q, v, tau))
    period_run = eng._get_period_run("rk4")
    period = count(lambda: period_run.plain(q, v, cmd))
    run = eng._get_rollout_run("count", ctrl, base.n_ctrl_per_step)
    carry = torch.zeros((1, ctrl.n_carry), dtype=q.dtype)

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


# The op counts run on the CPU at B=1, in worker processes (spawned: no CUDA
# there) beside the card's phases: main() hands them those that need no main
# path's state at the start, the constrained and the Digit's once their main
# paths ran; a phase takes its counts when it builds its records.


def counting_worker():
    """Initializer of the counting workers: one thread each."""
    import torch

    torch.set_num_threads(1)


def spring_op_counts(model):
    """`plain_op_counts` of env id `model` on the CPU, structural zeros folded
    away and not: (ops, ops_generic)."""
    import torch

    from jiminy_torch.envs import make

    env_cpu = make(model, device="cpu", dtype=torch.float64)
    return plain_op_counts(env_cpu, prune_zeros=True), plain_op_counts(env_cpu, prune_zeros=False)


# --------------------------------------------------------------------------- #
# Phases
# --------------------------------------------------------------------------- #


def phase_build():
    """The kernels' build (`kernels.build()`: the parts of csrc/cdyn.cu, an
    nvcc each, all at once, then linked): its time, each part's, and its
    ptxas summary; then the library is bound."""
    from jiminy_torch.ops import kernels

    res = kernels.build()
    parts = ", ".join(f"{t:.1f}" for t in res.part_seconds)
    log(f"[build] {res.path.name}: "
        f"{'reused' if res.reused else f'nvcc {res.seconds:.1f} s (its parts done at {parts} s)'}")
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
        outs, refs = run.kernel(q, v, cmd), replayed(run.plain)(q, v, cmd)
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
            refs = replayed(run.plain)(q, v, action, carry, n_ticks=2, n_substeps=2)
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


def phase_dopri(device, smi, glue=None):
    """Adaptive DOPRI on the card (phase 5): the main path, its launches and
    trials, the kernel/glue split, and the kernel against the plain version
    over N_PERIODS_DOPRI_F64 periods at float64."""
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
    per_trial, per_period = waited(glue, "DOPRI's glue count") if glue is not None else dopri_glue_calls()
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

    # N_PERIODS_DOPRI_F64 periods at float64 from the standing robot of the main path, its
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
        for _ in range(N_PERIODS_DOPRI_F64):
            x = eng64.step(x, cmd)
        runs[route] = x
    del eng64._cdyn.accel
    torch.cuda.synchronize()
    k, p = runs["kernel"], runs["plain"]
    tk, tp = (r.stepper.iterations + r.stepper.iter_failed for r in (k, p))
    e64 = max(float(column_errors(a, b).max()) for a, b in ((k.q, p.q), (k.v, p.v), (k.a, p.a)))
    log(f"[dopri] float64 B={B_DOPRI_F64}, {N_PERIODS_DOPRI_F64} period(s), velocities perturbed: "
        f"trials kernel / plain mean "
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


class _ReplayedSubstep:
    """A plain version's substep `fn(*groups)` (component lists in, component
    lists out) replayed from a CUDA graph: its first call for an input shape
    and dtype runs eagerly (the capture's warm-up); the second captures the
    same call on copies of its inputs and replays it, as do later calls:
    they copy their inputs in, replay, and return clones of the outputs. The
    same torch kernels on the same inputs, bit for bit, without the host's
    launch overhead (a plain substep is some 10^4-10^5 elementwise launches,
    host-bound when eager); a shape called once pays no capture."""

    def __init__(self, fn):
        self.fn, self.graphs, self.seen = fn, {}, set()

    def __call__(self, *groups):
        import torch

        from jiminy_torch.ops import cdyn

        tensors = [x for g in groups for x in g if isinstance(x, torch.Tensor)]
        batch = torch.broadcast_shapes(*(x.shape for x in tensors))
        ins = [cdyn._stack(list(g), batch, tensors[0]) for g in groups]
        key = tuple((tuple(x.shape), x.dtype) for x in ins)
        if key not in self.seen:
            self.seen.add(key)
            return self.fn(*groups)
        entry = self.graphs.get(key)
        if entry is None:
            static = [x.clone() for x in ins]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                res = self.fn(*([x[..., i] for i in range(x.shape[-1])] for x in static))
                res = [cdyn._stack(list(r), batch, tensors[0]) for r in res]
            self.graphs[key] = entry = (graph, static, res)
        graph, static, res = entry
        for dst, src in zip(static, ins):
            dst.copy_(src)
        graph.replay()
        return tuple(list(r.clone().unbind(-1)) for r in res)


# The replayed substeps of the runs of the current phase, kept (with their
# graphs) until `free_replays` (after every phase, or once the card's
# reserved memory passes REPLAY_MEMORY_CAP): id(run) -> (run, replay)
_REPLAYS = {}
REPLAY_MEMORY_CAP = 40e9  # bytes


def replayed(plain):
    """`plain`, a bound plain version of a period or rollout integrator,
    called with its substeps replayed from CUDA graphs (`_ReplayedSubstep`,
    one a run, its graphs kept for the phase): the same outputs, bit for
    bit."""
    import torch

    run = plain.__self__
    if torch.cuda.memory_reserved() > REPLAY_MEMORY_CAP:
        free_replays()  # bound what the phase's graphs hold on the card
    if id(run) not in _REPLAYS:
        _REPLAYS[id(run)] = (run, _ReplayedSubstep(run.substep))
    replay = _REPLAYS[id(run)][1]

    def call(*args, **kw):
        own = run.__dict__.get("substep")
        run.substep = replay
        try:
            return plain(*args, **kw)
        finally:
            if own is None:
                del run.substep
            else:
                run.substep = own

    return call


def _host_memory():
    """This process's resident memory and the host's available memory."""
    fields = {}
    for path, keys in (("/proc/self/status", ("VmRSS",)), ("/proc/meminfo", ("MemAvailable",))):
        try:
            with open(path) as f:
                for line in f:
                    key = line.split(":")[0]
                    if key in keys:
                        fields[key] = int(line.split()[1]) / 1e6
        except OSError:
            pass
    return ", ".join(f"{k} {v:.1f} GB" for k, v in fields.items())


def free_replays():
    """Free the phase's CUDA graphs and their memory pools."""
    import torch

    _REPLAYS.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


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


def _spring_geometry(eng, nm, n_carry):
    """The spring kernels' launch geometry and shared memory an env for the
    engine's model (a PD rollout of `nm` motors and an `n_carry` carry), and
    the envs an SM the runtime keeps, at float32 and float64."""
    from jiminy_torch.ops import kernels

    c = eng._cdyn.pack(None, 0.0, (), eng.device, eng.dtype).counts
    geometry = {}
    lib = kernels.load()
    for name, widths in (("cdyn_accel", None), ("cdyn_period", (nm, 0, 0)),
                         ("cdyn_rollout", (nm, nm, n_carry))):
        per_env = {elt: lib.accel_smem_bytes(c["nj"], c["nq"], c["nv"], c["nc"], elt)
                   if widths is None else
                   lib.sp_smem_bytes(c["nj"], c["nq"], c["nv"], c["nc"], *widths, elt)
                   for elt in (4, 8)}
        lanes, envs = per_env[4][1:]
        per_sm = {elt: lib.sp_envs_per_sm(name, elt, per_env[elt][0]) for elt in (4, 8)}
        geometry[name] = {"lanes_per_env": lanes, "envs_per_block": envs,
                          "smem_per_env": per_env[4][0], "smem_per_env_f64": per_env[8][0],
                          "envs_per_sm": per_sm[4], "envs_per_sm_f64": per_sm[8]}
        log(f"[smem] {eng.robot.name} {name}: {lanes} lanes an env, {envs} envs a block; "
            f"{per_env[4][0]} B of shared memory an env at float32, {per_env[8][0]} B at float64 "
            f"({envs * per_env[4][0]} / {envs * per_env[8][0]} B a block); the runtime keeps "
            f"{per_sm[4]} / {per_sm[8]} envs an SM")
        check(per_sm[4] > 0 and per_sm[8] > 0, f"{name}: no block of {eng.robot.name} fits an SM")
    return geometry


def phase_kernel_records(model, env, launches, smi, st, st2, check_ticks=None, dopri=None,
                         counts=None, check_substeps=None):
    """The three spring kernels at the main path's shapes (B = B_MAIN) for
    `model` (the env id of `env`, float32 on the card), `launches` each
    kernel's count in its main path's run.

    - float32 on the main path's own states (`st` after the fused steps,
      `st2` after the per-period steps): the kernel timed with CUDA events,
      its plain version with the host clock, their largest difference, and
      TOL's float32 measure printed beside the kernel against itself with q
      moved one ulp; cdyn_accel also timed on a DOPRI trial's stage states
      (`dopri`, phase 5). These standing states are not held at float32:
      there the accelerations are small differences of large contact and
      gravity forces, which float32 rounding alone moves by a large share.
    - float64 on the same states: every output column within TOL in every
      env; a zeroed output is refused.
    - float64 on perturbed states (`perturbed_states`, seed 0: feet in the
      ground, joints past their bounds, random velocities, torques, commands
      and actions): the same, except that the rollout may stray in up to
      F64_CHAOS_SHARE of the envs. Beside it, the kernel against itself on
      the input moved by one ulp: the share of envs that rounding alone
      carries as far. Then a batch one env short (the last block of envs
      part-filled) against the same plain outputs.
    - float32 on the perturbed states: every output column within TOL
      (90th percentile over envs, relative to the column's RMS).

    With `check_ticks`, every rollout held against its plain version runs
    that many controller ticks (a humanoid's 16 ticks carry a one-ulp
    difference far); a whole plain step is not run, so the record's
    `plain_ms` is null and the kernel and the plain version are timed over
    those ticks (`ms_part`, `plain_ms_part`); with `check_substeps`, the
    period alike over that many substeps. `counts` is a future of
    `spring_op_counts(model)` (counted here without it).
    """
    import torch

    from jiminy_torch.envs import make
    from jiminy_torch.ops import cdyn
    from jiminy_torch.testing import perturbed_states

    device = env.device
    env64 = make(model, device=device, dtype=torch.float64)
    base, block, ctrl, carry_of = _step_controller(env)
    base64, _, ctrl64, _ = _step_controller(env64)
    engines = {torch.float32: base.engine, torch.float64: base64.engine}
    elt = 4
    nq, nv, nm = env.robot.nq, env.robot.nv, env.robot.nmotors
    ops, ops_generic = (waited(counts, f"{model}'s op counts") if counts is not None else
                        spring_op_counts(model))
    log(f"[ops] {model} plain-version ops per env, structural zeros folded away: {ops}")
    log(f"[ops] {model} plain-version ops per env, generic formulation (what the kernels run): "
        f"{ops_generic}")

    n_ticks = base.n_ctrl_per_step

    def fns(name, dtype, ticks=None):
        eng = engines[dtype]
        if name == "cdyn_accel":
            return eng._cdyn.accel_kernel, eng._cdyn.accel_plain
        if name == "cdyn_period":
            run = eng._get_period_run("rk4")
            return (lambda *xs: run.kernel(*xs, n_substeps=ticks),
                    lambda *xs: replayed(run.plain)(*xs, n_substeps=ticks))
        run = eng._get_rollout_run(block, ctrl if dtype == torch.float32 else ctrl64, n_ticks)
        return (lambda *xs: run.kernel(*xs, n_ticks=ticks),
                lambda *xs: replayed(run.plain)(*xs, n_ticks=ticks))

    # Main path states, float32 as stepped
    q, v = st.sim.q.contiguous(), st.sim.v.contiguous()
    tau = engines[torch.float32]._compute_efforts(st.sim.command, v)[1]
    q2, v2, cmd2 = st2.sim.q.contiguous(), st2.sim.v.contiguous(), st2.sim.command.contiguous()
    carry = carry_of(st)
    action = torch.zeros((B_MAIN, nm), dtype=torch.float32, device=device)
    main_inputs = {"cdyn_accel": (q, v, tau), "cdyn_period": (q2, v2, cmd2),
                   "cdyn_rollout": (q, v, action, carry)}

    # Perturbed states, the same values at both dtypes
    def perturbed(dtype):
        qp, vp, taup = perturbed_states(env64, B_MAIN, seed=0)
        cmdp = _commands(B_MAIN, nm, torch.float64, device, seed=0)
        _, actp, carryp = _rollout_inputs(env64, qp, torch.float64, device,
                                          "zoh" if block == "zoh" else "pd", 0)
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
    n_time = {"cdyn_accel": 20, "cdyn_period": 5, "cdyn_rollout": 3}
    geometry = _spring_geometry(engines[torch.float32], nm, carry.shape[1])

    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def run_pair(name, dtype, xs, ticks):
        kern, plain = fns(name, dtype, ticks)
        outs, refs = as_tuple(kern(*xs)), as_tuple(plain(*xs))
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(o).all()) for o in outs), f"{name}: non-finite kernel output")
        return outs, refs

    def plain_time(plain, xs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs = as_tuple(plain(*xs))
        torch.cuda.synchronize()
        return refs, (time.perf_counter() - t0) * 1e3

    records = []
    for name in ("cdyn_accel", "cdyn_period", "cdyn_rollout"):
        integrated = name != "cdyn_accel"
        tol64 = TOL["float64"][integrated]
        tol32 = TOL["float32"][integrated]
        ticks = {"cdyn_rollout": check_ticks, "cdyn_period": check_substeps}.get(name)
        unit, of = (("ticks", n_ticks) if name == "cdyn_rollout" else
                    ("substeps", engines[torch.float32].n_substeps))
        span = f" ({ticks} {unit})" if ticks else ""

        # float32, main path states: timing and distance
        xs = main_inputs[name]
        kern32 = fns(name, torch.float32)[0]
        ms = _time_cuda(lambda: kern32(*xs), n_time[name])
        ms_stage = None
        if name == "cdyn_accel" and dopri:
            ms_stage = _time_cuda(lambda: kern32(*dopri["stage_inputs"]), n_time[name])
        kern_c, plain_c = fns(name, torch.float32, ticks)
        outs = as_tuple(kern_c(*xs))
        refs, plain_ms = plain_time(plain_c, xs)
        plain_basis, ms_part, plain_part = "measured", None, None
        if ticks:  # a whole plain step is not run: both timed over the ticks held
            ms_part, plain_part, plain_ms = _time_cuda(lambda: kern_c(*xs), 1), plain_ms, None
            plain_basis = (f"not measured: the plain version's whole launch was not run; over "
                           f"{ticks} of {of} {unit} it took plain_ms_part, the kernel ms_part")
        e_abs = abs_err(outs, refs)
        e32_path, at32_path = output_error(outs, refs, "float32")
        nudged = (torch.nextafter(xs[0], torch.full_like(xs[0], math.inf)),) + xs[1:]
        e32_ulp, _ = output_error(as_tuple(kern_c(*nudged)), outs, "float32")
        log(f"[check] {model} {name} float32 B={B_MAIN}{span}, main path states (printed, not "
            f"held): {ERR_NAME['float32']} {e32_path:.3e} at {at32_path}, max abs err {e_abs:.3e}; "
            f"the kernel against itself with q moved one ulp {e32_ulp:.3e}")
        del outs, refs

        # float64, main path states: every column, every env
        outs, refs = run_pair(name, torch.float64, tuple(x.double() for x in xs), ticks)
        e64_main, at64_main = output_error(outs, refs, "float64")
        e_zero, _ = output_error(tuple(torch.zeros_like(o) for o in outs), refs, "float64")
        log(f"[check] {model} {name} float64 B={B_MAIN}{span}, main path states: column max rel "
            f"err {e64_main:.3e} at {at64_main} (tol {tol64:g}); a zeroed output {e_zero:.3e}")
        check(e64_main < tol64, f"{model} {name} float64 disagrees on the main path's states: "
              f"{e64_main}")
        check(e_zero > tol64, f"{model} {name}: the check passes a zeroed output")
        del outs, refs

        # float64, perturbed states, with the one-ulp witness
        xs = pert[torch.float64][name]
        kern64 = fns(name, torch.float64, ticks)[0]
        outs, refs = run_pair(name, torch.float64, xs, ticks)
        e64_pert, at64_pert = output_error(outs, refs, "float64")
        share = share_beyond(outs, refs, tol64)
        nudged = (torch.nextafter(xs[0], torch.full_like(xs[0], math.inf)),) + xs[1:]
        outs_n = as_tuple(kern64(*nudged))
        share_n = share_beyond(outs_n, outs, tol64)
        e_nudge, at_nudge = output_error(outs_n, outs, "float64")
        allowed = F64_CHAOS_SHARE if name == "cdyn_rollout" else 0.0
        log(f"[check] {model} {name} float64 B={B_MAIN}{span}, perturbed states: column max rel "
            f"err {e64_pert:.3e} at {at64_pert}; share of envs beyond {tol64:g}: {share:.3e} "
            f"(allowed {allowed:g}); the kernel against itself with q moved one ulp: "
            f"{e_nudge:.3e} at {at_nudge}, share beyond {tol64:g}: {share_n:.3e}")
        check(share <= allowed, f"{model} {name} float64 disagrees on perturbed states: "
              f"share {share}")
        # the last block of envs part-filled, against the same plain outputs
        b_rag = B_MAIN - 1
        outs_rag = as_tuple(kern64(*(x[:b_rag] for x in xs)))
        share_rag = share_beyond(outs_rag, tuple(r[:b_rag] for r in refs), tol64)
        log(f"[check] {model} {name} float64 B={b_rag} (ragged){span}, perturbed states: share "
            f"of envs beyond {tol64:g}: {share_rag:.3e} (allowed {allowed:g})")
        check(all(bool(torch.isfinite(o).all()) for o in outs_rag), f"{name}: non-finite output")
        check(share_rag <= allowed, f"{model} {name} float64 disagrees at B={b_rag}: {share_rag}")
        del outs_rag
        del outs, refs, outs_n

        # float32, perturbed states: per column, q90 over envs / column RMS
        outs, refs = run_pair(name, torch.float32, pert[torch.float32][name], ticks)
        e32_pert, at32_pert = output_error(outs, refs, "float32")
        log(f"[check] {model} {name} float32 B={B_MAIN}{span}, perturbed states: column q90 err "
            f"/ rms {e32_pert:.3e} at {at32_pert} (tol {tol32:g}); max abs err "
            f"{abs_err(outs, refs):.3e}")
        check(e32_pert < tol32, f"{model} {name} float32 disagrees on perturbed states: "
              f"{e32_pert}")
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
            "model": model,
            "check_ticks": ticks if name == "cdyn_rollout" else None,
            "check_substeps": ticks if name == "cdyn_period" else None,
            "plain_ms_basis": plain_basis,
            "ms_part": ms_part,
            "plain_ms_part": plain_part,
            "ops_per_env": ops[name],
            "ops_per_env_generic": ops_generic[name],
            "bound_ms_generic": max(t_ops_generic, t_bytes),
            "bytes_per_env": io_per_env[name] * elt,
            "f32_q90_err_main": e32_path,
            "f32_q90_err_main_one_ulp": e32_ulp,
            "f64_err_main": e64_main,
            "f64_err_perturbed": e64_pert,
            "f64_share_perturbed": share,
            "f64_share_one_ulp": share_n,
            "f32_q90_err_perturbed": e32_pert,
            "f64_share_ragged": share_rag,
            **({"ms_dopri_stage": ms_stage, "launches_path": "dopri",
                "dopri_trials_mean": dopri["trials_mean"], "dopri_trials_max": dopri["trials_max"],
                "dopri_env_steps_per_s": dopri["steps_per_s"]} if ms_stage else {}),
            **geometry[name],
        }
        stage_note = f" ({ms_stage:.4f} ms on DOPRI stage states)" if ms_stage else ""
        plain_txt = (f"plain {plain_ms:.1f} ms (host clock, measured)" if not ticks else
                     f"plain not timed over the whole launch; over {ticks} {unit} the kernel "
                     f"{ms_part:.3f} ms (CUDA events), the plain version {plain_part:.1f} ms "
                     f"(host clock)")
        log(f"[kernel] {model} {name} B={B_MAIN} float32: {ms:.4f} ms{stage_note} (CUDA events), "
            f"{plain_txt}, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}; generic formulation {rec['bound_ms_generic']:.4f} ms), "
            f"{rec['bound_ms'] / ms:.2%} of it; |kernel-plain| on the main path's states"
            f"{span} {e_abs:.3e}; launches {rec['launches']} on {smi}")
        records.append(rec)
    return records


# --------------------------------------------------------------------------- #
# Atlas (atlas-reduced-pid, atlas-pid): the three spring kernels at the
# full 36-dof humanoid
# --------------------------------------------------------------------------- #


def _golden_row(sim, reward, i):
    import numpy as np

    return np.concatenate([[float(sim.t[i])], sim.q[i].cpu().numpy(), sim.v[i].cpu().numpy(),
                           [float(reward[i])], sim.contact_forces[i].cpu().numpy().ravel()])


def phase_atlas_golden(device):
    """atlas-reduced-pid at float64 through the kernels, both paths, against
    tests/goldens/atlas-reduced-pid.csv. After the feet touch down the
    standing Atlas amplifies a difference tenfold a controller tick, so no
    program that rounds otherwise than the golden's can stay within
    GOLDEN_ATOL of it: env 0 is held to GOLDEN_REACH times the largest
    distance between it and two witnesses started with the base height one
    ulp up and down (envs 1, 2), plus GOLDEN_ATOL, row by row."""
    import numpy as np
    import torch

    from jiminy_torch.envs import make
    from jiminy_torch.ops import cdyn

    golden = np.loadtxt(os.path.join(ROOT, "tests", "goldens", "atlas-reduced-pid.csv"),
                        delimiter=",", skiprows=1)
    for fused in (True, False):
        genv = make("atlas-reduced-pid", device=device, dtype=torch.float64)
        genv.use_fused_rollout = fused
        gst, _ = genv.reset(batch_size=3)
        q = gst.sim.q.clone()
        for w, to in ((1, math.inf), (2, -math.inf)):
            q[w, 2] = torch.nextafter(q[w, 2], torch.tensor(to, dtype=q.dtype, device=device))
        gst = gst.replace(sim=gst.sim.replace(q=q))
        zero = torch.zeros(genv.action_size, dtype=torch.float64, device=device)
        cdyn.reset_launch_counts()
        worst = 0.0
        for k in range(ATLAS_GOLDEN_ROWS):
            gst, _, rew, term, *_ = genv.step(gst, zero)
            own = _golden_row(gst.sim, rew, 0)
            dist = float(np.abs(own - golden[k]).max())
            spread = max(float(np.abs(_golden_row(gst.sim, rew, w) - own).max()) for w in (1, 2))
            limit = GOLDEN_REACH * spread + GOLDEN_ATOL
            worst = max(worst, dist / limit)
            log(f"[atlas golden] float64 {'fused' if fused else 'per-period'} row {k}: max abs "
                f"err {dist:.3e}, one-ulp witnesses {spread:.3e} (limit {limit:.3e})")
            check(not bool(term.any()), "atlas-reduced-pid terminated on the golden path")
            check(spread < 1.0 and dist <= limit,
                  f"atlas-reduced-pid golden row {k} beyond rounding's reach: {dist} > {limit}")
        kern = "cdyn_rollout" if fused else "cdyn_period"
        per_step = 1 if fused else genv.env.n_ctrl_per_step
        check(cdyn.KERNELS[kern].launches == ATLAS_GOLDEN_ROWS * per_step,
              f"the atlas golden rows did not go through {kern}")
        log(f"[atlas golden] {'fused' if fused else 'per-period'}: {ATLAS_GOLDEN_ROWS} rows, "
            f"worst err / limit {worst:.3f}; {kern} launches {cdyn.KERNELS[kern].launches}")


def phase_atlas_main_path(device, smi):
    """atlas-pid at float32 on the card, B = B_MAIN: counts to 0, batched
    reset, a warm-up step and N_STEPS_ATLAS steps of zero actions, counts
    read; then the per-period path for a step."""
    import torch

    from jiminy_torch.envs import make
    from jiminy_torch.ops import cdyn

    env = make("atlas-pid", device=device)  # float32 on the card
    nq, nv, nm = env.robot.nq, env.robot.nv, env.robot.nmotors
    log(f"[atlas] atlas-pid: nq {nq}, nv {nv}, {env.robot.model.njoints} joints, "
        f"{len(env.robot.contact_frame_indices)} contact points, {nm} motors, "
        f"{env.env.n_ctrl_per_step} controller ticks x {env.env.engine.n_substeps} substeps a step")
    action = torch.zeros(env.action_size, device=device)
    cdyn.reset_launch_counts()
    t0 = time.perf_counter()
    st, _ = env.reset(batch_size=B_MAIN)
    torch.cuda.synchronize()
    reset_ms = (time.perf_counter() - t0) * 1e3
    st, *_ = env.step(st, action)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_STEPS_ATLAS):
        st, obs, reward, term, trunc, _ = env.step(st, action)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    log(f"[atlas main] atlas-pid float32 B={B_MAIN}, reset ({reset_ms:.1f} ms) + warm-up + "
        f"{N_STEPS_ATLAS} steps: launches {launches}")
    check(launches["cdyn_rollout"] == N_STEPS_ATLAS + 1, "atlas: cdyn_rollout not once a step")
    check(launches["cdyn_accel"] >= 1, "atlas: cdyn_accel did not run at reset")
    for name, x in (("q", st.sim.q), ("v", st.sim.v), ("reward", reward),
                    ("contact_forces", st.sim.contact_forces)):
        check(bool(torch.isfinite(x).all()), f"atlas: non-finite {name} after the main path")
    check(st.sim.q.shape == (B_MAIN, nq), "atlas: unexpected state shape")
    fell = float(term.float().mean())
    steps_per_s = B_MAIN * N_STEPS_ATLAS / elapsed
    log(f"[atlas main] base height mean {float(st.sim.q[:, 2].mean()):.4f} m, terminated share "
        f"{fell:.4f}; env-steps/s {steps_per_s:.1f} ({elapsed:.4f} s for {N_STEPS_ATLAS} steps, "
        f"host clock) on {smi}")
    carry = st.blocks[env.block.name].reshape(B_MAIN, -1).contiguous()
    ctrl = env.env._component_controllers[env.block.name]
    run = env.env.engine._get_rollout_run(env.block.name, ctrl, env.env.n_ctrl_per_step)
    q, v = st.sim.q.contiguous(), st.sim.v.contiguous()
    zero = torch.zeros((B_MAIN, nm), dtype=torch.float32, device=device)
    step_ms = _time_cuda(lambda: run.kernel(q, v, zero, carry), 2)
    log(f"[atlas main] cdyn_rollout launch {step_ms:.2f} ms (CUDA events), "
        f"{step_ms / (1e3 * elapsed / N_STEPS_ATLAS):.3f} of a step")

    env.use_fused_rollout = False
    st2, *_ = env.step(st, action)
    torch.cuda.synchronize()
    cdyn.reset_launch_counts()
    t0 = time.perf_counter()
    st2, *_ = env.step(st2, action)
    torch.cuda.synchronize()
    elapsed_pp = time.perf_counter() - t0
    period_launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    log(f"[atlas main] per-period path, 1 step: launches {period_launches}; env-steps/s "
        f"{B_MAIN / elapsed_pp:.1f} on {smi}")
    check(period_launches["cdyn_period"] == env.env.n_ctrl_per_step,
          "atlas: cdyn_period did not run once per controller period")
    check(bool(torch.isfinite(st2.sim.q).all()), "atlas: non-finite q on the per-period path")
    return env, launches, period_launches, steps_per_s, st, st2


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


def physics_checks(env, sim, joints=None):
    """Checks a zeroed or wrong solver fails, on the final state of the
    constrained main path (the robot at rest on its feet): `joints` those
    held within their limits (by default the bound rows')."""
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
    qi = [model.idx_q[j] for j in (cset.bound_joint_indices if joints is None else joints)]
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
    b_min = float(lam_b.min()) if nb else 0.0  # no bound row: none to hold
    log(f"[cm-physics] min bound multiplier {b_min:.3e} ({nb} bound rows), min normal multiplier "
        f"{float(lam_n.min()):.3e}, max ||lam_t|| - mu lam_n (1 + 1e-5) {cone:.3e}")
    check(b_min >= 0.0 and float(lam_n.min()) >= 0.0, "negative boxed multiplier")
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


def _slim_state(st, block):
    """Env 0 of a constrained main path's state on the CPU, with what
    `constrained_op_counts` reads (picklable, for a counting worker)."""
    from types import SimpleNamespace

    sim = st.sim
    fields = ("q", "v", "command", "lam", "contact_active", "bound_active")
    return SimpleNamespace(sim=SimpleNamespace(**{k: getattr(sim, k)[:1].cpu() for k in fields}),
                           blocks={block: st.blocks[block][:1].cpu()})


def cm_op_counts(st):
    """`constrained_op_counts` of anymal-pid in constraint mode on the CPU at
    state `st` (`_slim_state`), zero operands folded away and not."""
    import torch

    env_cpu = _cm_make("cpu", torch.float64)
    return (constrained_op_counts(env_cpu, st, fold_zeros=True),
            constrained_op_counts(env_cpu, st, fold_zeros=False))


def phase_constrained_records(env, launches, period_launches, smi, st, st2, counters=None):
    """The two constrained kernels at B = B_MAIN, records for the kernels
    line; the ops counted on the CPU meanwhile, by `counters` (an executor)
    where given. Each kernel is timed over its whole launch and, beside its
    plain version, over the reduced counts every check runs (`plain_ms`
    null, `ms_part` and `plain_ms_part` over `cut_compared`)."""
    import dataclasses
    import torch

    from jiminy_torch.engine import solver
    from jiminy_torch.ops import cdyn, kernels
    from jiminy_torch.testing import column_errors, column_quantile_errors, constrained_inputs

    device = env.device
    env64 = _cm_make(device, torch.float64)
    engines = {torch.float32: env.engine, torch.float64: env64.engine}
    nm = env.robot.nmotors
    block = env.block.name
    ctrl = env.env._component_controllers[block]
    n_ticks = env.env.n_ctrl_per_step

    slim = _slim_state(st, block)
    counting = counters.submit(cm_op_counts, slim) if counters else None
    ops = ops_generic = None

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
    lib = kernels.load()
    n_time = {"cdyn_period_cm": 5, "cdyn_rollout_cm": 3}
    tol64, tol32 = TOL["float64"][1], TOL["float32"][1]
    records = []
    for name in ("cdyn_period_cm", "cdyn_rollout_cm"):
        # float32, main path states: the whole launch timed; beside the plain
        # version, over the reduced counts
        run32 = run_of(name, engines[torch.float32])
        xs = main_inputs[name]
        cut = reduced(name)
        ms = _time_cuda(lambda: run32.kernel(*xs), n_time[name])
        ms_part = _time_cuda(lambda: run32.kernel(*xs, **cut), n_time[name])
        outs = run32.kernel(*xs, **cut)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs = replayed(run32.plain)(*xs, **cut)
        torch.cuda.synchronize()
        plain_part = (time.perf_counter() - t0) * 1e3
        e_abs = abs_err(outs, refs)
        del outs, refs

        # float64, main path states, reduced counts: every column, every env
        run64 = run_of(name, engines[torch.float64])
        xs64 = tuple(x.double() for x in xs)
        outs, refs = run64.kernel(*xs64, **reduced(name)), replayed(run64.plain)(*xs64, **reduced(name))
        torch.cuda.synchronize()
        e64_main, at64_main = output_error(outs, refs, "float64")
        log(f"[cm-check] {name} float64 B={B_MAIN} ({reduced(name)}), main path states: column "
            f"max rel err {e64_main:.3e} at {at64_main} (tol {tol64:g})")
        check(all(bool(torch.isfinite(o).all()) for o in outs) and e64_main < tol64,
              f"{name} float64 disagrees on the main path's states: {e64_main}")
        del outs, refs

        # float64, active rows, reduced counts; the one-ulp and the solver witnesses
        xs = active[name]
        outs, refs = run64.kernel(*xs, **reduced(name)), replayed(run64.plain)(*xs, **reduced(name))
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
        outs, refs = run32.kernel(*xs32, **reduced(name)), replayed(run32.plain)(*xs32, **reduced(name))
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
            outs, refs = run64.kernel(*xs, **reduced(name)), replayed(run64.plain)(*xs, **reduced(name))
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
            outs, refs = run32.kernel(*xs32, **reduced(name)), replayed(run32.plain)(*xs32, **reduced(name))
            torch.cuda.synchronize()
            e32x, at32x = output_error(outs, refs, "float32")
            check(e32x < tol32, f"{name} float32 disagrees ({rows} rows active): {e32x}")
            del outs, refs
            log(f"[cm-check] {name} B={B_MAIN} ({reduced(name)}), {rows} rows active at the first "
                f"solve ({n_act:.2f} nonzero multipliers per env at the end): float64 column max "
                f"rel err {e64x:.3e} at {at64x}, share beyond {tol64:g} {share_x:.3e}; float32 "
                f"q90 {e32x:.3e} at {at32x}")
            extreme_errs[rows] = (e64x, share_x, e32x)

        if ops is None:
            ops, ops_generic = (waited(counting, "the constrained op counts") if counting else
                                cm_op_counts(slim))
            log(f"[cm-ops] plain-version scalar ops per env at the main path's state, zero "
                f"operands folded away: {ops}")
            log(f"[cm-ops] the same, every element op: {ops_generic}")
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
            "plain_ms": None,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
            "model": "anymal-pid",
            "plain_ms_basis": (f"not measured: the plain version's whole launch was not run; over "
                               f"{cut} it took plain_ms_part, the kernel ms_part"),
            "cut_compared": cut,
            "ms_part": ms_part,
            "plain_ms_part": plain_part,
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
            **_cm_geometry_record(lib, device, run32, run_of(name, engines[torch.float64]), name,
                                  False, False),
        }
        log(f"[kernel] {name} B={B_MAIN} float32: {ms:.3f} ms (CUDA events); over {cut} the kernel "
            f"{ms_part:.3f} ms (CUDA events), the plain version {plain_part:.1f} ms (host clock); "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; every element op "
            f"{rec['bound_ms_generic']:.4f} ms); {_geometry_text(rec)}; |kernel-plain| on the "
            f"main path's states {e_abs:.3e} on {smi}")
        records.append(rec)
    return records


# --------------------------------------------------------------------------- #
# Toys: the generic path (cartpole, acrobot) and the pendulum through the
# constrained kernels
# --------------------------------------------------------------------------- #

TOYS = ("cartpole", "acrobot", "pendulum")
TOY_GOLDEN_ATOL = 1e-10  # the CPU tests hold the toys' goldens to 1e-10 (measured 5.6e-16)
N_STEPS_TOYS = {"cartpole": 3, "acrobot": 1, "pendulum": 3}  # toy main path, after a warm-up
B_GENERIC_F64 = 2048  # anymal-pid generic-path cross-check against the kernels
GENERIC_TOL = 1e-9


def _toy_initial_states():
    """{env_id: (q0, v0, n_rows)} from tests/goldens_torch/toy_initial_states.json:
    jiminy_tpu's reset states of tests/golden_configs.py, as exact hex floats."""
    path = os.path.join(ROOT, "tests", "goldens_torch", "toy_initial_states.json")
    with open(path) as f:
        raw = json.load(f)
    return {k: ([float.fromhex(x) for x in r["q0"]], [float.fromhex(x) for x in r["v0"]],
                int(r["n_rows"])) for k, r in raw.items()}


def _actions_sin(n_rows, action_size):
    """tests/golden_configs.py::_actions_sin (that module imports JAX)."""
    import numpy as np

    t = np.arange(n_rows)[:, None]
    return 0.3 * np.sin(0.37 * t) * np.ones((1, action_size))


def phase_toy_golden(device):
    """The toys' golden rows at float64, B=1, through `make(...)` on the card,
    from jiminy_tpu's initial states, with the golden actions. The CPU
    tests show no amplification of rounding (5.6e-16 from the goldens over
    every row), so each row is held to TOY_GOLDEN_ATOL. The pendulum's rows
    go through cdyn_rollout_cm (default path, once a step) and
    cdyn_period_cm (per-period path, once a controller period); the cartpole
    and the acrobot launch no kernel, and their per-period path is their
    default path (the generic engine has no fused rollout)."""
    import numpy as np
    import torch

    from jiminy_torch.envs import make
    from jiminy_torch.ops import cdyn

    t_phase = time.perf_counter()
    states = _toy_initial_states()
    for env_id in TOYS:
        q0, v0, n_rows = states[env_id]
        golden = np.loadtxt(os.path.join(ROOT, "tests", "goldens", f"{env_id}.csv"),
                            delimiter=",", skiprows=1)
        check(len(golden) == n_rows, f"{env_id}: golden rows and initial states disagree")
        env = make(env_id, device=device, dtype=torch.float64)
        paths = (True, False) if env.engine.supports_fused_rollout else (True,)
        check((env_id == "pendulum") == (len(paths) == 2),
              f"{env_id}: unexpected path (fused rollout {env.engine.supports_fused_rollout})")
        actions = _actions_sin(n_rows, env.action_size)
        for fused in paths:
            env.use_fused_rollout = fused
            st, _ = env.reset_at(torch.tensor([q0], dtype=torch.float64, device=device),
                                 torch.tensor([v0], dtype=torch.float64, device=device))
            cdyn.reset_launch_counts()
            t0 = time.perf_counter()
            worst = 0.0
            for k in range(n_rows):
                st, _, rew, *_ = env.step(st, torch.as_tensor(actions[k], device=device))
                row = _golden_row(st.sim, rew, 0)
                worst = max(worst, float(np.abs(row - golden[k]).max()))
            elapsed = time.perf_counter() - t0
            launches = {k: c.launches for k, c in cdyn.KERNELS.items() if c.launches}
            path = "default" if fused else "per-period"
            log(f"[toy golden] {env_id} float64 B=1 {path}: {n_rows} rows, max abs err {worst:.3e} "
                f"(tol {TOY_GOLDEN_ATOL:g}), launches {launches}, {elapsed:.1f} s")
            check(worst < TOY_GOLDEN_ATOL, f"{env_id} golden rows not reproduced on the card")
            if env_id != "pendulum":
                check(not launches, f"{env_id} launched a kernel on the generic path")
            elif fused:
                check(launches == {"cdyn_rollout_cm": n_rows},
                      "the pendulum's rows did not go through cdyn_rollout_cm once a step")
            else:
                check(launches == {"cdyn_period_cm": n_rows * env.n_ctrl_per_step},
                      "the pendulum's rows did not go through cdyn_period_cm once a period")
    log(f"[toy golden] phase {time.perf_counter() - t_phase:.1f} s")


def phase_toy_main_path(device, smi):
    """Each toy at float32 on the card, B = B_MAIN: batched reset (the
    initial states drawn by a seeded torch.Generator), a warm-up step, launch
    counts to 0, N_STEPS_TOYS steps of zero actions, counts read; the
    pendulum also one step of its per-period path."""
    import torch

    from jiminy_torch.envs import make
    from jiminy_torch.ops import cdyn

    t_phase = time.perf_counter()
    out = {}
    for env_id in TOYS:
        env = make(env_id, device=device)  # float32 on the card
        action = torch.zeros(env.action_size, device=device)
        gen = torch.Generator(device).manual_seed(TOYS.index(env_id))
        st, _ = env.reset(batch_size=B_MAIN, generator=gen)
        st, *_ = env.step(st, action)  # warm-up
        torch.cuda.synchronize()
        n_steps = N_STEPS_TOYS[env_id]
        cdyn.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            st, obs, reward, term, trunc, _ = env.step(st, action)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
        steps_per_s = B_MAIN * n_steps / elapsed
        for name, x in (("q", st.sim.q), ("v", st.sim.v), ("reward", reward), ("obs", obs)):
            check(bool(torch.isfinite(x).all()), f"{env_id}: non-finite {name} on its main path")
        fell = float(term.float().mean())
        log(f"[toy main] {env_id} float32 B={B_MAIN}, {n_steps} steps: {steps_per_s:.1f} "
            f"env-steps/s ({elapsed / n_steps * 1e3:.1f} ms a step, host clock), launches "
            f"{launches}, terminated share {fell:.4f} on {smi}")
        check(fell == 0.0, f"{env_id} terminated on its main path")
        rec = {"steps_per_s": steps_per_s, "step_ms": elapsed / n_steps * 1e3, "launches": launches,
               "env": env, "st": st}
        if env_id == "pendulum":
            check(launches["cdyn_rollout_cm"] == n_steps and sum(launches.values()) == n_steps,
                  "the pendulum's step did not run cdyn_rollout_cm once (and nothing else)")
            check(bool((st.sim.lam == 0).all()) and not bool(st.sim.bound_active.any()),
                  "the pendulum's bound row (+-100 rad) activated on its main path")
            kernel_ms = _time_cuda(lambda: env.step(st, action), 3)
            env.use_fused_rollout = False
            st2, *_ = env.step(st, action)
            torch.cuda.synchronize()
            cdyn.reset_launch_counts()
            t0 = time.perf_counter()
            st2, *_ = env.step(st2, action)
            torch.cuda.synchronize()
            pp_ms = (time.perf_counter() - t0) * 1e3
            period_launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
            check(period_launches["cdyn_period_cm"] == env.n_ctrl_per_step
                  and sum(period_launches.values()) == env.n_ctrl_per_step,
                  "the pendulum's per-period step did not run cdyn_period_cm once a period")
            check(bool(torch.isfinite(st2.sim.q).all()), "non-finite q on the pendulum's periods")
            env.use_fused_rollout = True
            log(f"[toy main] pendulum step {kernel_ms:.3f} ms (CUDA events around env.step); "
                f"per-period path {B_MAIN / pp_ms * 1e3:.1f} env-steps/s ({pp_ms:.1f} ms a step, "
                f"launches {period_launches}) on {smi}")
            rec.update(st2=st2, period_launches=period_launches, pp_steps_per_s=B_MAIN / pp_ms * 1e3)
        else:
            check(sum(launches.values()) == 0, f"{env_id} launched a kernel on the generic path")
        out[env_id] = rec
    log(f"[toy main] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def _generic_anymal_check(device):
    """One step of anymal-pid at float64 on B_GENERIC_F64 envs through the
    generic path (plain torch, the PD block eager, period by period) and
    through the kernels (cdyn_rollout), from the same states: every column
    within GENERIC_TOL."""
    import torch

    from jiminy_torch.envs import make
    from jiminy_torch.ops import cdyn
    from jiminy_torch.testing import column_errors

    kern = make("anymal-pid", device=device, dtype=torch.float64)
    gen = make("anymal-pid", device=device, dtype=torch.float64,
               options=kern.engine.options.replace(use_fast_dynamics=False))
    check(gen.engine._cdyn is None and not gen.engine.supports_fused_rollout,
          "use_fast_dynamics=False did not select the generic path")
    action = torch.zeros(kern.action_size, dtype=torch.float64, device=device)
    st, _ = kern.reset(batch_size=B_GENERIC_F64)
    st, *_ = kern.step(st, action)  # the feet on the ground
    action = (_commands(B_GENERIC_F64, kern.action_size, torch.float64, device, seed=7)
              * 0.005)
    cdyn.reset_launch_counts()
    a, *_ = kern.step(st, action)
    kern_launches = {k: c.launches for k, c in cdyn.KERNELS.items() if c.launches}
    cdyn.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b, *_ = gen.step(st, action)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = {k: c.launches for k, c in cdyn.KERNELS.items() if c.launches}
    check(not gen_launches and kern_launches == {"cdyn_rollout": 1},
          f"unexpected launches: generic {gen_launches}, kernel path {kern_launches}")
    worst, where = 0.0, ""
    pairs = [("q", a.sim.q, b.sim.q), ("v", a.sim.v, b.sim.v), ("a", a.sim.a, b.sim.a),
             ("contact_forces", a.sim.contact_forces.flatten(1), b.sim.contact_forces.flatten(1)),
             ("pd", a.blocks["pd_controller"].flatten(1), b.blocks["pd_controller"].flatten(1))]
    pairs += [(k, a.sim.measurements[k].flatten(1), b.sim.measurements[k].flatten(1))
              for k in a.sim.measurements]
    for name, x, y in pairs:
        e = column_errors(y, x)
        if float(e.max()) > worst:
            worst, where = float(e.max()), f"{name}[{int(e.argmax())}]"
    log(f"[generic] anymal-pid float64 B={B_GENERIC_F64}, one step: generic path against the "
        f"kernels, column max rel err {worst:.3e} at {where} (tol {GENERIC_TOL:g}); generic "
        f"step {gen_s:.2f} s (host clock), kernel path launches {kern_launches}")
    check(worst < GENERIC_TOL, f"the generic path disagrees with the kernels: {worst} at {where}")
    return {"err": worst, "generic_step_s": gen_s}


def pendulum_op_counts(env_cpu, q, v, cc, bc, fold_zeros):
    """Ops per env of one pendulum period (1 substep + the final solve) and
    one env step (n_ticks x (ZOH controller + 1 substep) + the end-of-tick
    solves + the final solve), counted on the plain version at B=1."""
    import torch

    eng = env_cpu.engine
    qc, vc = [q[..., i] for i in range(q.shape[-1])], [v[..., i] for i in range(v.shape[-1])]
    ccl = [cc[..., i] for i in range(cc.shape[-1])]
    bcl = [bc[..., i] for i in range(bc.shape[-1])]
    acl = [torch.zeros(1, dtype=torch.float64)] * env_cpu.action_size
    run = eng._get_period_run("rk4")
    rrun = eng._get_rollout_run("zoh", env_cpu._component_controllers["zoh"], env_cpu.n_ctrl_per_step)

    def count(fn):
        return count_elem_ops(fn, fold_zeros)

    sub = count(lambda: run.substep(qc, vc, ccl))
    fin = count(lambda: run.final_outputs(qc, vc, ccl))
    ctl = count(lambda: rrun.controller_fn(qc, vc, bcl, acl))
    post = count(lambda: rrun.post_tick_fn(qc, vc, ccl, bcl))
    n_sub, n_ticks = run.n_substeps, rrun.n_ticks
    return {"cdyn_period_cm": n_sub * sub + fin,
            "cdyn_rollout_cm": n_ticks * (ctl + n_sub * sub) + (n_ticks - 1) * post + fin}


def phase_pendulum_records(toys, smi):
    """The two constrained kernels on the pendulum (fixed root, 1 joint, 0
    contacts, 1 bound row; 50 ticks of 1 RK4 substep a step behind a ZOH
    controller) at B = B_MAIN, at their full tick and substep counts:
    float32 on the main path's states, timed against the plain version;
    float64 on the main path's states, on perturbed states (a quarter of the
    envs past the bound), with every row and with no row active at the
    first solve, and one env short (the last block part-filled), every
    column within TOL; witnesses: a zeroed acceleration column on the path
    states and zeroed multipliers with every row active fail the check.
    Records for the kernels line with "model": "pendulum"."""
    import torch

    from jiminy_torch.envs import make
    from jiminy_torch.ops import cdyn, kernels
    from jiminy_torch.testing import bound_row_inputs, column_errors, column_quantile_errors

    t_phase = time.perf_counter()
    rec_toy = toys["pendulum"]
    env, st, st2 = rec_toy["env"], rec_toy["st"], rec_toy["st2"]
    device = env.device
    env64 = make("pendulum", device=device, dtype=torch.float64)
    env64.step(env64.reset(batch_size=4)[0], torch.zeros(1, dtype=torch.float64, device=device))
    engines = {torch.float32: env.engine, torch.float64: env64.engine}
    nm, n_ticks = env.robot.nmotors, env.n_ctrl_per_step

    def run_of(name, dtype):
        eng, e = engines[dtype], (env if dtype == torch.float32 else env64)
        if name == "cdyn_period_cm":
            return eng._get_period_run("rk4")
        return eng._get_rollout_run("zoh", e._component_controllers["zoh"], n_ticks)

    def main_inputs(name, dtype):
        if name == "cdyn_period_cm":
            cmd = st2.sim.command.expand(B_MAIN, nm)
            return (st2.sim.q.to(dtype), st2.sim.v.to(dtype),
                    torch.cat([cmd, _cm_solver_row(st2.sim, torch.float32)], -1).to(dtype))
        return (st.sim.q.to(dtype), st.sim.v.to(dtype), st.sim.command.expand(B_MAIN, nm).to(dtype),
                _cm_solver_row(st.sim, torch.float32).to(dtype))

    def inputs_of(name, rows, dtype):
        q, v, cmd, sol = bound_row_inputs(env64, B_MAIN, seed=1, rows=rows)
        xs = (q, v, torch.cat([cmd, sol], -1)) if name == "cdyn_period_cm" else (q, v, cmd, sol)
        return tuple(x.to(dtype) for x in xs)

    env_cpu = make("pendulum", device="cpu", dtype=torch.float64)
    env_cpu.step(env_cpu.reset(batch_size=1)[0], torch.zeros(1, dtype=torch.float64))
    q1, v1 = st.sim.q[:1].double().cpu(), st.sim.v[:1].double().cpu()
    sol1 = _cm_solver_row(st.sim, torch.float32)[:1].double().cpu()
    cc1 = torch.cat([st.sim.command.expand(B_MAIN, nm)[:1].double().cpu(), sol1], -1)
    ops = pendulum_op_counts(env_cpu, q1, v1, cc1, sol1, fold_zeros=True)
    ops_generic = pendulum_op_counts(env_cpu, q1, v1, cc1, sol1, fold_zeros=False)
    log(f"[pendulum-ops] plain-version scalar ops per env, zero operands folded away: {ops}; "
        f"every element op: {ops_generic}")

    nq, nv = env.robot.nq, env.robot.nv
    cset = env.engine.cset
    n_solver = cset.total_rows + cset.n_contacts + cset.n_bounds
    n_extra = nv + n_solver
    n_cc, n_carry = nm + n_solver, n_solver
    io_per_env = {"cdyn_period_cm": 2 * nq + 2 * nv + n_cc + n_extra,
                  "cdyn_rollout_cm": 2 * nq + 2 * nv + nm + n_carry + n_extra + n_cc + n_carry}
    lam_cols = slice(nv, nv + cset.total_rows)
    n_launch = {"cdyn_period_cm": rec_toy["period_launches"]["cdyn_period_cm"],
                "cdyn_rollout_cm": rec_toy["launches"]["cdyn_rollout_cm"]}
    lib = kernels.load()
    tol64, tol32 = TOL["float64"][1], TOL["float32"][1]
    records = []
    for name in ("cdyn_period_cm", "cdyn_rollout_cm"):
        run32, run64 = run_of(name, torch.float32), run_of(name, torch.float64)
        geometry = _cm_geometry_record(lib, device, run32, run64, name, False, False)
        # float32, the main path's states: timing
        xs = main_inputs(name, torch.float32)
        ms = _time_cuda(lambda: run32.kernel(*xs), 5)
        outs = run32.kernel(*xs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs = replayed(run32.plain)(*xs)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        e_abs = abs_err(outs, refs)
        e32_main, _ = output_error(outs, refs, "float32")
        del outs, refs
        errs = {}
        # float64: the main path's states, perturbed states, every row and no row active
        for case in ("main", "mixed", "all", "none"):
            xs64 = main_inputs(name, torch.float64) if case == "main" else inputs_of(name, case, torch.float64)
            outs, refs = run64.kernel(*xs64), replayed(run64.plain)(*xs64)
            torch.cuda.synchronize()
            e64, at64 = output_error(outs, refs, "float64")
            check(all(bool(torch.isfinite(o).all()) for o in outs), f"{name}: non-finite output ({case})")
            lam = refs[2][:, lam_cols]
            n_act = float((lam != 0).double().sum(-1).mean())
            msg = ""
            if case == "main":
                zeroed = outs[2].clone()
                zeroed[:, :nv] = 0.0
                e_zero = float(column_errors(zeroed, refs[2]).max())
                check(e_zero > tol64, f"{name}: the float64 check misses a zeroed acceleration")
                check(bool((outs[2][:, lam_cols] == 0).all()),
                      f"{name}: a multiplier on the pendulum's path (its row never activates)")
                msg = f"; witness: acceleration zeroed {e_zero:.3e}"
            elif case == "all":
                zeroed = outs[2].clone()
                zeroed[:, lam_cols] = 0.0
                e_zero = float(column_errors(zeroed, refs[2]).max())
                check(e_zero > tol64, f"{name}: the float64 check misses zeroed multipliers")
                msg = f"; witness: multipliers zeroed {e_zero:.3e}"
            elif case == "none":
                check(bool((outs[2][:, lam_cols] == 0).all()), f"{name}: a multiplier with no row active")
            log(f"[pendulum-check] {name} float64 B={B_MAIN}, {case} states: column max rel err "
                f"{e64:.3e} at {at64} (tol {tol64:g}); {n_act:.2f} nonzero multipliers an env{msg}")
            check(e64 < tol64, f"{name} float64 disagrees on the pendulum's {case} states: {e64}")
            errs[case] = e64
            if case == "mixed":
                b_rag = B_MAIN - 1
                outs_rag = run64.kernel(*(x[:b_rag] for x in xs64))
                e_rag, _ = output_error(outs_rag, tuple(r[:b_rag] for r in refs), "float64")
                log(f"[pendulum-check] {name} float64 B={b_rag} (ragged), mixed states: column max "
                    f"rel err {e_rag:.3e}")
                check(e_rag < tol64, f"{name} float64 disagrees at B={b_rag}: {e_rag}")
                errs["ragged"] = e_rag
                del outs_rag
                xs32 = tuple(x.float() for x in xs64)
                outs32, refs32 = run32.kernel(*xs32), replayed(run32.plain)(*xs32)
                e32, at32 = output_error(outs32, refs32, "float32")
                log(f"[pendulum-check] {name} float32 B={B_MAIN}, mixed states: column q90 err / "
                    f"rms {e32:.3e} at {at32} (tol {tol32:g})")
                check(e32 < tol32, f"{name} float32 disagrees on the pendulum's mixed states: {e32}")
                errs["f32_mixed"] = e32
                del outs32, refs32
            del outs, refs
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
            "model": "pendulum",
            "ops_per_env": ops[name],
            "ops_per_env_generic": ops_generic[name],
            "bound_ms_generic": max(t_ops_generic, t_bytes),
            "bytes_per_env": io_per_env[name] * 4,
            "f32_q90_err_main": e32_main,
            "f64_err_main": errs["main"],
            "f64_err_mixed": errs["mixed"],
            "f64_err_all_active": errs["all"],
            "f64_err_none_active": errs["none"],
            "f64_err_ragged": errs["ragged"],
            "f32_q90_err_mixed": errs["f32_mixed"],
            **geometry,
        }
        log(f"[kernel] {name} pendulum B={B_MAIN} float32: {ms:.3f} ms (CUDA events), plain "
            f"{plain_ms:.1f} ms (host clock), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
            f"every element op {rec['bound_ms_generic']:.4f} ms); {_geometry_text(rec)}; "
            f"|kernel-plain| on the main path's states {e_abs:.3e} on {smi}")
        records.append(rec)
    log(f"[pendulum-check] phase {time.perf_counter() - t_phase:.1f} s")
    return records


# --------------------------------------------------------------------------- #
# PPO training (phases 15-17)
# --------------------------------------------------------------------------- #

PPO_ANYMAL = dict(n_envs=4096, n_steps=16, n_epochs=2, n_minibatches=4, hidden=(256, 256))
N_ITERS_PPO = 5  # timed iterations, after one warm-up
PPO_CARTPOLE = dict(n_envs=32, n_steps=64, n_epochs=4, n_minibatches=4, total_iterations=35,
                    lr=3e-4, ent_coef=0.01)
PPO_F64_TOL = 1e-9  # card against CPU at float64: trajectory and metrics, of their scale
PPO_PARAM_ULPS = 16  # parameters and Adam moments (float32): ulps of their scale


class _CudaSpans:
    """`span(name)` for `make_train`: CUDA events around every entry of a
    span, while `on`."""

    def __init__(self):
        self.events, self.on = {}, False

    @contextlib.contextmanager
    def __call__(self, name):
        import torch

        if not self.on:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.events.setdefault(name, []).append((start, end))

    def total_ms(self):
        """Each span's summed ms (call after a synchronize)."""
        return {k: sum(s.elapsed_time(e) for s, e in ev) for k, ev in self.events.items()}


def phase_ppo_anymal(device, smi):
    """PPO on anymal-pid at full width (phase 15): the shape of jiminy_tpu's
    training benchmark (`benchmarks/ppo_train.py:59-91`) at 4096 envs,
    float32. One warm-up iteration, then N_ITERS_PPO timed ones with the
    launch counts set to 0 just before and read just after: every rollout
    step is one cdyn_rollout launch and one cdyn_accel launch (the auto-reset
    resets the whole batch every step, as jiminy_tpu's does, and the reset's
    one dynamics evaluation is cdyn_accel), and nothing else launches."""
    import torch

    from jiminy_torch.envs import make
    from jiminy_torch.gym import FlattenObservation
    from jiminy_torch.ops import cdyn
    from jiminy_torch.rl import PPOConfig, make_train

    t_phase = time.perf_counter()
    env = FlattenObservation(make("anymal-pid", horizon=1000, device=device))
    cfg = PPOConfig(**PPO_ANYMAL)
    spans = _CudaSpans()
    init_fn, train_step = make_train(env, cfg, span=spans)
    state = init_fn(torch.Generator(device).manual_seed(0))
    params0 = {k: p.clone() for k, p in state.params.items()}
    state, _ = train_step(state)  # warm-up
    torch.cuda.synchronize()

    history = []
    cdyn.reset_launch_counts()
    spans.on = True
    t0 = time.perf_counter()
    for _ in range(N_ITERS_PPO):
        state, metrics = train_step(state)
        history.append(metrics)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    spans.on = False
    launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    n_env_steps = cfg.n_steps * N_ITERS_PPO
    expected = {k: 0 for k in launches}
    expected.update(cdyn_rollout=n_env_steps, cdyn_accel=n_env_steps)
    log(f"[ppo anymal] {N_ITERS_PPO} iterations of {cfg.n_envs} envs x {cfg.n_steps} steps: "
        f"launches {launches} (expected {expected}: one cdyn_rollout an env step, one "
        f"cdyn_accel an auto-reset, which resets the batch every step)")
    check(launches == expected,
          "PPO's rollout did not run through cdyn_rollout and cdyn_accel alone")
    steps_per_s = cfg.n_envs * n_env_steps / elapsed
    total = spans.total_ms()
    split = {k: total[k] / N_ITERS_PPO for k in ("rollout", "gae", "update")}
    iter_ms = elapsed / N_ITERS_PPO * 1e3
    log(f"[ppo anymal] training env-steps/s {steps_per_s:.1f} ({iter_ms:.1f} ms an iteration, host "
        f"clock around synchronised iterations, CUDA events on the spans) on {smi}")
    log(f"[ppo anymal] an iteration (CUDA events): rollout {split['rollout']:.2f} ms, GAE "
        f"{split['gae']:.3f} ms, update {split['update']:.2f} ms, the rest "
        f"{iter_ms - sum(split.values()):.2f} ms")
    # A rollout step's pieces, from the same iterations: the policy forward
    # and sample, the env step, the auto-reset's batched reset and its pick
    step_ms = split["rollout"] / cfg.n_steps
    pieces = {k: total[k] / n_env_steps for k in ("policy", "env_step", "reset", "pick")}
    pieces["rest"] = step_ms - sum(pieces.values())
    auto_reset_ms = pieces["reset"] + pieces["pick"]
    log(f"[ppo anymal] a rollout step {step_ms:.3f} ms (CUDA events inside the timed rollouts): "
        + ", ".join(f"{k} {v:.3f} ms ({v / step_ms:.1%})" for k, v in pieces.items())
        + f"; the auto-reset (reset and pick) {auto_reset_ms:.3f} ms, "
        f"{auto_reset_ms / step_ms:.1%} of the step; the policy forward "
        f"{pieces['policy'] / step_ms:.1%}; on {smi}")

    # Checks on the trained state
    for k, p in state.params.items():
        check(bool(torch.isfinite(p).all()), f"non-finite parameter {k}")
    check(any(not torch.equal(p, params0[k]) for k, p in state.params.items()),
          "the parameters did not move")
    for i, m in enumerate(history):
        for k, v in m.items():
            check(bool(torch.isfinite(v).all()), f"non-finite metric {k} at iteration {i}")
        kl = float(m["approx_kl_pos"])
        check(0.0 <= kl < 1.0, f"approx_kl_pos {kl} at iteration {i} outside [0, 1)")
    sim = state.env_state.sim
    check(bool(torch.isfinite(sim.q).all() and torch.isfinite(sim.v).all()),
          "non-finite env state after training")
    check(not bool(sim.stepper.diverged.any()), "an env diverged during training")
    last = {k: float(v) for k, v in history[-1].items()}
    log("[ppo anymal] last iteration: " + ", ".join(f"{k} {v:.4g}" for k, v in last.items()))
    log(f"[ppo anymal] phase {time.perf_counter() - t_phase:.1f} s")
    return {"steps_per_s": steps_per_s, "launches": launches, "split": split, "pieces": pieces}


def phase_ppo_cartpole(device, smi):
    """PPO learns the cartpole on the card (phase 16): jiminy_tpu's
    `tests/test_training.py::test_ppo_learns_cartpole` whole, at float64 as
    that test runs (its conftest enables x64), seed 42, and its bars; the 5
    greedy episodes as one batch of envs."""
    import numpy as np
    import torch

    from jiminy_torch.envs import make
    from jiminy_torch.rl import PPOConfig, evaluate_batch, policy_from_params, train
    from jiminy_torch.rl.networks import ActorCritic

    t_phase = time.perf_counter()
    cfg = PPOConfig(**PPO_CARTPOLE)
    state, hist = train(make("cartpole", device=device, dtype=torch.float64), cfg,
                        generator=torch.Generator(device).manual_seed(42))
    train_s = time.perf_counter() - t_phase
    early = np.mean([h["mean_done"] for h in hist[:5]])
    late = np.mean([h["mean_done"] for h in hist[-5:]])
    lens = [h["episode_length_mean"] for h in hist]
    log(f"[ppo cartpole] {cfg.total_iterations} iterations in {train_s:.1f} s "
        f"({cfg.n_envs * cfg.n_steps * cfg.total_iterations / train_s:.1f} env-steps/s with the "
        f"updates) on {smi}; mean_done early {early:.4f} late {late:.4f}; episode length mean "
        f"first {lens[0]:.1f} last {lens[-1]:.1f}")
    check(late < early, "the cartpole's episodes did not get longer")
    check(hist[0]["episodes"] > 0, "no episode finished in the first iteration")
    for i, h in enumerate(hist):
        if h["episodes"] > 0:
            check(h["episode_length_mean"] > 0 and np.isfinite(h["episode_return_mean"]),
                  f"episode stats at iteration {i}")
            check(abs(h["episode_return_mean"] - h["episode_length_mean"]) < 5.0,
                  f"episode return does not track its length at iteration {i}")
    early_len = np.mean(lens[:5])
    late_lens = [h["episode_length_mean"] for h in hist[-5:] if h["episodes"] > 0]
    check(not late_lens or np.mean(late_lens) > early_len, "episode lengths did not grow")
    net = ActorCritic(4, 1, cfg.hidden, device=device)
    t0 = time.perf_counter()
    stats = evaluate_batch(make("cartpole", device=device, dtype=torch.float64),
                           policy_from_params(net, state.params),
                           n_episodes=5, n_steps=500,
                           generator=torch.Generator(device).manual_seed(100))
    log(f"[ppo cartpole] 5 greedy episodes: lengths {stats['episodes']['length'].tolist()}, mean "
        f"{stats['length_mean']:.1f} (bar > 100; untrained about 25), "
        f"{time.perf_counter() - t0:.1f} s")
    check(stats["length_mean"] > 100, "the greedy cartpole policy does not balance")
    log(f"[ppo cartpole] phase {time.perf_counter() - t_phase:.1f} s")
    return {"train_s": train_s, "length_mean": stats["length_mean"]}


def _ppo_step_on(env, cfg, params, q0, v0, draws):
    """One train_step of `env` (its device) from the given parameters, initial
    states and draws (the auto-reset's among them). Returns (new state,
    metrics, trajectory, launches)."""
    import torch

    from jiminy_torch.gym import flatten_pytree
    from jiminy_torch.ops import cdyn
    from jiminy_torch.rl import make_train

    dev, dt = env.device, env.dtype
    init_fn, train_step = make_train(env, cfg)
    state = init_fn(torch.Generator(dev).manual_seed(0))
    env_state, obs = env.reset_at(q0.to(dev, dt), v0.to(dev, dt))
    state = state.replace(params={k: p.to(dev) for k, p in params.items()}, env_state=env_state,
                          last_obs=flatten_pytree(obs, 1))
    record = {}
    cdyn.reset_launch_counts()
    new, metrics = train_step(state, {k: x.to(dev) for k, x in draws.items()}, record)
    launches = {k: c.launches for k, c in cdyn.KERNELS.items() if c.launches}
    return new, metrics, record["traj"], launches


PPO_CASES = (  # phase 17: env id, horizon, PPOConfig sizes, launches of each kernel
    ("cartpole", 5, dict(n_envs=8, n_steps=8, n_epochs=2, n_minibatches=2), 0),
    ("anymal-pid", 1, dict(n_envs=16, n_steps=2, n_epochs=1, n_minibatches=1), 2),
)


def _ppo_case(env_id, horizon, sizes, device):
    """(env on `device`, config, parameters, initial q and v, draws) of a
    phase 17 case: the parameters, initial states and draws made on the CPU
    from one seed, the same in every process."""
    import torch

    from jiminy_torch.envs import make
    from jiminy_torch.gym import FlattenObservation
    from jiminy_torch.rl import PPOConfig, make_train

    cfg = PPOConfig(**sizes)
    cpu_env = FlattenObservation(make(env_id, device="cpu", dtype=torch.float64,
                                      horizon=horizon))
    gen = torch.Generator().manual_seed(17)
    init_fn, _ = make_train(cpu_env, cfg)
    state = init_fn(gen)
    q0, v0 = state.env_state.sim.q, state.env_state.sim.v
    n_total = cfg.n_envs * cfg.n_steps
    reset_q, reset_v = cpu_env._sample_state((cfg.n_steps, cfg.n_envs), gen)
    draws = {
        "action": torch.randn((cfg.n_steps, cfg.n_envs, cpu_env.action_size),
                              dtype=torch.float64, generator=gen),
        "perm": torch.stack([torch.randperm(n_total, generator=gen)
                             for _ in range(cfg.n_epochs)]),
        "reset_q": reset_q.contiguous(),
        "reset_v": reset_v.contiguous(),
    }
    env = cpu_env if str(device) == "cpu" else FlattenObservation(
        make(env_id, device=device, dtype=torch.float64, horizon=horizon))
    return env, cfg, state.params, q0, v0, draws


def ppo_cpu_step(env_id, horizon, sizes):
    """Phase 17's CPU side of a case: one train_step on the CPU. Returns what
    the card's step is held to (new parameters, Adam moments and count,
    carried observation and state), the metrics, the trajectory and the
    step's seconds."""
    env, cfg, params, q0, v0, draws = _ppo_case(env_id, horizon, sizes, "cpu")
    t0 = time.perf_counter()
    new, metrics, traj, _ = _ppo_step_on(env, cfg, params, q0, v0, draws)
    seconds = time.perf_counter() - t0
    out = {"params": new.params, "mu": new.opt_state["mu"], "nu": new.opt_state["nu"],
           "count": int(new.opt_state["count"]), "last_obs": new.last_obs,
           "q": new.env_state.sim.q, "v": new.env_state.sim.v}
    return out, metrics, traj, seconds


def phase_ppo_card_vs_cpu(device, smi, cpu_steps=None):
    """One train_step on the card against the CPU at float64 (phase 17), from
    the same parameters, initial states and draws: the cartpole (8 envs x 8
    steps, 2 x 2, horizon 5 so every env auto-resets inside the rollout) on
    the generic path, and anymal-pid (16 envs x 2 steps, 1 x 1, horizon 1 so
    every env auto-resets at every step and the fresh states feed the next
    step) through cdyn_rollout and cdyn_accel on the card against the plain
    versions on the CPU. The trajectory, the metrics and the carried
    observations within PPO_F64_TOL of their scale (max(1, |x|));
    parameters and Adam moments, stored in float32, within PPO_PARAM_ULPS
    float32 ulps of their scale (the first moment at the gradients' RMS,
    which it sums), as the CPU tests hold the port to jiminy_tpu.
    `cpu_steps` maps an env id to a future of its `ppo_cpu_step` (a worker
    process runs the CPU side); without it the CPU side runs here."""
    import torch

    t_phase = time.perf_counter()
    f32_eps = float(torch.finfo(torch.float32).eps)
    for env_id, horizon, sizes, n_launch in PPO_CASES:
        gpu_env, cfg, params, q0, v0, draws = _ppo_case(env_id, horizon, sizes, device)
        c_new, c_met, c_traj, cpu_s = (
            waited(cpu_steps[env_id], f"{env_id}'s CPU step") if cpu_steps else
            ppo_cpu_step(env_id, horizon, sizes))
        g_new, g_met, g_traj, launches = _ppo_step_on(gpu_env, cfg, params, q0, v0, draws)
        torch.cuda.synchronize()
        want = {"cdyn_rollout": n_launch, "cdyn_accel": n_launch} if n_launch else {}
        check(launches == want, f"{env_id}: card step launches {launches}, expected {want}")

        def err(a, b):
            a, b = a.double().cpu(), b.double().cpu()
            return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))

        worst_traj = max(err(g_traj[k], c_traj[k]) for k in c_traj)
        worst_met = max(err(g_met[k], c_met[k]) for k in c_met)
        worst_carry = max(err(g_new.last_obs, c_new["last_obs"]),
                          err(g_new.env_state.sim.q, c_new["q"]),
                          err(g_new.env_state.sim.v, c_new["v"]))
        worst_ulps = 0.0
        count = c_new["count"]
        for k, p in c_new["params"].items():
            nu = c_new["nu"][k].double()
            rms = float((nu.max() / (1 - 0.999**count)).sqrt())
            for out, ref, scale in ((g_new.params[k], p, float(p.abs().max())),
                                    (g_new.opt_state["mu"][k], c_new["mu"][k], rms),
                                    (g_new.opt_state["nu"][k], nu, float(nu.abs().max()))):
                e = float((out.double().cpu() - ref.double()).abs().max())
                worst_ulps = max(worst_ulps, e / (f32_eps * scale) if scale > 0 else e)
        dones = int(c_traj["done"].sum())
        want_dones = cfg.n_envs * (cfg.n_steps // horizon)
        log(f"[ppo card-vs-cpu] {env_id} float64 {cfg.n_envs} envs x {cfg.n_steps} steps, "
            f"{cfg.n_epochs} x {cfg.n_minibatches}, horizon {horizon}: trajectory "
            f"{worst_traj:.3e}, metrics {worst_met:.3e}, carried state {worst_carry:.3e} of their "
            f"scale (tol {PPO_F64_TOL:g}); parameters and Adam moments {worst_ulps:.2f} float32 "
            f"ulps of their scale (tol {PPO_PARAM_ULPS}); {dones} auto-resets (expected "
            f"{want_dones}); card launches {launches}; CPU step {cpu_s:.1f} s")
        check(torch.equal(g_traj["done"].cpu(), c_traj["done"]), f"{env_id}: done differs")
        check(dones == want_dones, f"{env_id}: {dones} auto-resets, expected {want_dones}")
        check(max(worst_traj, worst_met, worst_carry) <= PPO_F64_TOL,
              f"{env_id}: the card's PPO step disagrees with the CPU's")
        check(worst_ulps <= PPO_PARAM_ULPS, f"{env_id}: the card's parameters disagree")
    log(f"[ppo card-vs-cpu] phase {time.perf_counter() - t_phase:.1f} s on {smi}")


# --------------------------------------------------------------------------- #
# Terrain (phase 18): the five kernels' terrain instances on rough ground,
# and anymal-pid on it in both contact modes
# --------------------------------------------------------------------------- #

N_STEPS_ROUGH = 25  # spring-damper main path on rough ground
N_STEPS_ROUGH_CM = 2  # constraint-mode main path on rough ground
B_ROUGH_CHECK = 4096  # cdyn_accel and the constrained pair held to their plain versions
ROUGH_HALF_WIDTH = 10.0  # the envs spread over a 20 m x 20 m square
ROUGH_TILT_RAD = 1e-3  # a contact normal "off vertical" beyond this
ROUGH_TILT_SHARE = 0.25  # at least this share of touching contacts is off vertical


def _rough_make(device, dtype, constraint=False):
    from jiminy_torch.envs import make
    from jiminy_torch.testing import constraint_mode_options, ground_options, rough_ground

    options = ground_options(make("anymal-pid", device=device, dtype=dtype).engine.options,
                             rough_ground())
    if constraint:
        options = constraint_mode_options(options)
    return make("anymal-pid", device=device, dtype=dtype, options=options)


def _rough_checks(device, envs, witness):
    """(a) and (b): the five kernels against their plain versions on states
    spread over the ground, at phase 3's and phase 8's cut sizes; then the
    witnesses that this check can fail."""
    import torch

    from jiminy_torch.ops import cdyn
    from jiminy_torch.testing import constrained_inputs, contact_points, perturbed_states
    from jiminy_torch.testing import spread_on_ground

    errs = {}
    for dtype in (torch.float64, torch.float32):
        name_t = str(dtype).split(".")[1]
        env, cm_env = envs[dtype]
        eng, cm_eng = env.engine, cm_env.engine
        ground = eng.ground_fn
        nm = env.robot.nmotors

        def held(kernel, outs, refs, integrated, what):
            e, where = output_error(outs, refs, name_t)
            tol = TOL[name_t][integrated]
            log(f"[terrain] {kernel} {name_t} {what}: {ERR_NAME[name_t]} {e:.3e} at {where} "
                f"(tol {tol:g})")
            check(all(bool(torch.isfinite(o).all()) for o in outs) and e < tol,
                  f"{kernel} on rough ground {name_t} disagrees: {e}")
            errs.setdefault(kernel, {})[name_t] = e

        q, v, tau = perturbed_states(env, B_ROUGH_CHECK, seed=0)
        q = spread_on_ground(q, ground, seed=0, half_width=ROUGH_HALF_WIDTH)
        out = eng._cdyn.accel_kernel(q, v, tau)
        ref = eng._cdyn.accel_plain(q, v, tau)
        held("cdyn_accel", (out,), (ref,), False, f"B={B_ROUGH_CHECK}")
        if dtype == torch.float64:  # (b) the flat instance misses the terrain
            cd = eng._cdyn
            flat = cdyn.ComponentDynamics(env.robot.model, cd.gravity, contact_opts=cd.contact_opts,
                                          contact_frames=cd.contact_frames,
                                          contact_radii=cd.contact_radii,
                                          bound_gains=cd.bound_gains)
            e_flat, _ = output_error((flat.accel_kernel(q, v, tau),), (ref,), "float64")
            witness["flat_kernel_vs_rough_plain_f64"] = e_flat
            log(f"[terrain] witness: the flat cdyn_accel on the same states against the rough "
                f"plain version: {ERR_NAME['float64']} {e_flat:.3e} (must exceed "
                f"{TOL['float64'][0]:g})")
            check(e_flat > TOL["float64"][0], "the flat kernel passes the terrain check")

        q, v, _ = perturbed_states(env, 64, seed=1)
        q = spread_on_ground(q, ground, seed=1, half_width=ROUGH_HALF_WIDTH)
        cmd = _commands(64, nm, dtype, device, seed=1)
        run = eng._get_period_run("rk4")
        held("cdyn_period", run.kernel(q, v, cmd), replayed(run.plain)(q, v, cmd), True,
             "B=64 (5 substeps)")
        ctrl, action, carry = _rollout_inputs(env, q, dtype, device, "pd", 2)
        run = eng._get_rollout_run("rough-check", ctrl, env.env.n_ctrl_per_step)
        outs = run.kernel(q, v, action, carry, n_ticks=2, n_substeps=2)
        refs = replayed(run.plain)(q, v, action, carry, n_ticks=2, n_substeps=2)
        held("cdyn_rollout", outs, refs, True, "B=64 (2 ticks x 2 substeps)")
        if dtype == torch.float64:  # (b) the contacts meet the terrain off vertical
            nv, nc = env.robot.nv, len(env.robot.contact_frame_indices)
            depth = refs[2][:, nv + 9 * nc:nv + 10 * nc]
            feet = contact_points(env, refs[0])
            h, (nx, ny, nz) = ground.height_components(feet[..., 0], feet[..., 1])
            tilt = torch.atan2(torch.hypot(nx, ny), nz)
            touching = depth < 0.0
            share = float((tilt[touching] > ROUGH_TILT_RAD).double().mean())
            witness["touching_contacts"] = int(touching.sum())
            witness["share_off_vertical"] = share
            log(f"[terrain] witness: {int(touching.sum())} touching contacts, "
                f"{share:.3f} of them more than {ROUGH_TILT_RAD:g} rad off vertical "
                f"(at least {ROUGH_TILT_SHARE:g})")
            check(share >= ROUGH_TILT_SHARE, "too few touching contacts meet a tilted ground")

        nm = cm_env.robot.nmotors
        qa, va, cmda, sola = constrained_inputs(cm_env, B_ROUGH_CHECK, seed=0)
        qa = spread_on_ground(qa, ground, seed=2, half_width=ROUGH_HALF_WIDTH)
        run = cm_eng._get_period_run("rk4")
        cc = torch.cat([cmda, sola], -1)
        held("cdyn_period_cm", run.kernel(qa, va, cc, n_substeps=CM_SUBSTEPS),
             replayed(run.plain)(qa, va, cc, n_substeps=CM_SUBSTEPS), True,
             f"B={B_ROUGH_CHECK} ({CM_SUBSTEPS} substeps)")
        ctrl = cm_env.block.component_controller(cm_env.env)
        run = cm_eng._get_rollout_run("rough-check", ctrl, cm_env.env.n_ctrl_per_step)
        blk = torch.zeros((B_ROUGH_CHECK, 3 * nm), dtype=dtype, device=device)
        blk[:, :nm] = qa[:, 7:]
        xs = (qa, va, cmda * 2.5, torch.cat([blk, sola], -1))
        held("cdyn_rollout_cm", run.kernel(*xs, n_ticks=CM_TICKS, n_substeps=CM_SUBSTEPS),
             replayed(run.plain)(*xs, n_ticks=CM_TICKS, n_substeps=CM_SUBSTEPS), True,
             f"B={B_ROUGH_CHECK} ({CM_TICKS} ticks x {CM_SUBSTEPS} substeps)")
    return errs


def _rough_main_path(env, n_steps, rollout, period, smi, label):
    """(c) one mode's main path on rough ground: reset, the envs placed on
    the ground (`place_on_ground`) and reset there, one warm-up step (its
    launches checked apart), the launch counts set to 0, n_steps steps of
    zero actions, counts read; then the per-period path one step. Returns
    (state, per-period state, launches, env-steps/s, reset launches,
    per-period launches)."""
    import torch

    from jiminy_torch.ops import cdyn
    from jiminy_torch.testing import place_on_ground

    device = env.device
    action = torch.zeros(env.action_size, device=device)
    cdyn.reset_launch_counts()
    st, _ = env.reset(batch_size=B_MAIN)
    gen = torch.Generator(device).manual_seed(18)
    q0 = place_on_ground(env, st.sim.q, env.engine.ground_fn, gen, half_width=ROUGH_HALF_WIDTH)
    st, _ = env.reset_at(q0, st.sim.v)
    torch.cuda.synchronize()
    reset_launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    cdyn.reset_launch_counts()
    st, *_ = env.step(st, action)  # warm-up: builds the block's rollout run
    torch.cuda.synchronize()
    warm = {k: c.launches for k, c in cdyn.KERNELS.items()}
    check(warm[rollout] == 1 and sum(warm.values()) == 1,
          f"the warm-up step on rough ground did not run {rollout} once ({label}): {warm}")
    cdyn.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        st, obs, reward, term, trunc, _ = env.step(st, action)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    log(f"[terrain-main] {label} float32 B={B_MAIN}, {n_steps} steps on rough ground: launches "
        f"{launches}")
    check(launches[rollout] == n_steps and sum(launches.values()) == n_steps,
          f"{rollout} did not run once a step on rough ground (and nothing else)")
    for name, x in (("q", st.sim.q), ("v", st.sim.v), ("reward", reward),
                    ("contact_forces", st.sim.contact_forces)):
        check(bool(torch.isfinite(x).all()), f"non-finite {name} on rough ground ({label})")
    steps_per_s = B_MAIN * n_steps / elapsed
    log(f"[terrain-main] {label} env-steps/s {steps_per_s:.1f} ({elapsed:.4f} s, host clock); "
        f"terminated share {float(term.float().mean()):.4f} (reported, not gated); base height "
        f"mean {float(st.sim.q[:, 2].mean()):.4f} m on {smi}")

    env.use_fused_rollout = False
    cdyn.reset_launch_counts()
    st2, *_ = env.step(st, action)
    torch.cuda.synchronize()
    period_launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    n_periods = env.env.n_ctrl_per_step
    log(f"[terrain-main] {label} per-period path, one step: launches {period_launches}")
    check(period_launches[period] == n_periods and sum(period_launches.values()) == n_periods,
          f"{period} did not run once a controller period on rough ground")
    check(bool(torch.isfinite(st2.sim.q).all()), f"non-finite q on the per-period path ({label})")
    env.use_fused_rollout = True
    return st, st2, launches, steps_per_s, reset_launches, period_launches


# Multiplies of one lattice hash as the device computes it (native uint32
# products, `terrain_hash2`); xors and shifts are not counted on either side
HASH_DEVICE_OPS = {"_hash2": 3, "_hash3": 4}


def _terrain_ops(env_cpu):
    """Scalar operations of one contact's terrain branch on the plain
    version (`ground_components`, the normal's normalization, the depth),
    counted per element at B=1 as `count_elem_ops` counts. The plain
    version emulates each lattice hash's uint32 products on int64 (16-bit
    halves and masks); each hash counts as its device multiplies instead:
    the calls are recorded, and each one's emulated count is replaced."""
    from unittest import mock

    import torch

    from jiminy_torch.ops import cdyn
    from jiminy_torch.utils import terrain

    ground = env_cpu.engine.ground_fn
    x, y, z = (torch.tensor([val], dtype=torch.float64) for val in (0.37, -1.21, 0.01))

    def branch():
        h, n = cdyn.ground_components(ground, x, y)
        nn = torch.sqrt(torch.clamp(cdyn.v_dot(n, n), min=1e-24))
        n = cdyn.v_scale(n, 1.0 / nn)
        return (z - h) * n[2]

    calls = []

    def recorded(name):
        fn = getattr(terrain, name)

        def hashed(*args):
            calls.append((fn, HASH_DEVICE_OPS[name], args))
            return fn(*args)
        return hashed

    with mock.patch.object(terrain, "_hash2", recorded("_hash2")), \
            mock.patch.object(terrain, "_hash3", recorded("_hash3")):
        total = count_elem_ops(branch, fold_zeros=True)
    emulated = sum(count_elem_ops(lambda: fn(*args), fold_zeros=True) for fn, _, args in calls)
    device = sum(n for _, n, _ in calls)
    return total - emulated + device, len(calls), emulated, device


def rough_terrain_ops():
    """`_terrain_ops` of anymal-pid on the rough ground, on the CPU."""
    import torch

    return _terrain_ops(_rough_make("cpu", torch.float64))


def phase_terrain_checks(device):
    """Phase 18 (a) and (b), which time nothing: (errors, witnesses)."""
    import torch

    envs = {dt: (_rough_make(device, dt), _rough_make(device, dt, constraint=True))
            for dt in (torch.float64, torch.float32)}
    witness = {}
    return _rough_checks(device, envs, witness), witness


# Phase 18 (d): the plain versions run, and the kernels are timed beside
# them, over one substep of the periods and one tick of the rollouts
ROUGH_CUT = {"cdyn_accel": {}, "cdyn_period": dict(n_substeps=1),
             "cdyn_rollout": dict(n_ticks=1), "cdyn_period_cm": dict(n_substeps=1),
             "cdyn_rollout_cm": dict(n_ticks=1)}


def phase_terrain(device, smi, records, checks, counts=None):
    """Phase 18 (c) and (d): the ground evaluated per contact inside the
    five kernels. `records` are the kernel records of the earlier phases
    (the flat kernels' times and op counts of anymal-pid); `checks` what
    `phase_terrain_checks` returned; `counts` a future of
    `rough_terrain_ops()` (counted here without it)."""
    import torch

    from jiminy_torch.ops import cdyn, kernels

    flat = {r["name"]: r for r in records if r.get("model") == "anymal-pid"}
    errs, witness = checks
    env, cm_env = _rough_make(device, torch.float32), _rough_make(device, torch.float32, True)
    st, st2, launches, sps, reset_launches, p_launches = _rough_main_path(
        env, N_STEPS_ROUGH, "cdyn_rollout", "cdyn_period", smi, "spring-damper")
    cst, cst2, cm_launches, cm_sps, _, cm_p_launches = _rough_main_path(
        cm_env, N_STEPS_ROUGH_CM, "cdyn_rollout_cm", "cdyn_period_cm", smi, "constraint mode")

    # (d) records: each kernel timed at B_MAIN on the rough main path's states
    nm = env.robot.nmotors
    eng, cm_eng = env.engine, cm_env.engine
    block = env.block.name
    n_ticks = env.env.n_ctrl_per_step
    run = eng._get_rollout_run(block, env.env._component_controllers[block], n_ticks)
    prun = eng._get_period_run("rk4")
    cm_block = cm_env.block.name
    cm_run = cm_eng._get_rollout_run(cm_block, cm_env.env._component_controllers[cm_block],
                                     n_ticks)
    cm_prun = cm_eng._get_period_run("rk4")
    zeros = torch.zeros((B_MAIN, nm), device=device)
    inputs = {
        "cdyn_accel": (eng._cdyn.accel_kernel, eng._cdyn.accel_plain,
                       (st.sim.q, st.sim.v, eng._compute_efforts(st.sim.command, st.sim.v)[1])),
        "cdyn_period": (prun.kernel, replayed(prun.plain), (st2.sim.q, st2.sim.v, st2.sim.command)),
        "cdyn_rollout": (run.kernel, replayed(run.plain),
                         (st.sim.q, st.sim.v, zeros, st.blocks[block].reshape(B_MAIN, -1))),
        "cdyn_period_cm": (cm_prun.kernel, replayed(cm_prun.plain),
                           (cst2.sim.q, cst2.sim.v, torch.cat(
                               [cst2.sim.command, _cm_solver_row(cst2.sim, torch.float32)], -1))),
        "cdyn_rollout_cm": (cm_run.kernel, replayed(cm_run.plain),
                            (cst.sim.q, cst.sim.v, zeros, torch.cat(
                                [cst.blocks[cm_block].reshape(B_MAIN, -1),
                                 _cm_solver_row(cst.sim, torch.float32)], -1))),
    }
    n_time = {"cdyn_accel": 20, "cdyn_period": 5, "cdyn_rollout": 3, "cdyn_period_cm": 3,
              "cdyn_rollout_cm": 2}
    main_launches = {"cdyn_accel": reset_launches["cdyn_accel"],
                     "cdyn_period": p_launches["cdyn_period"],
                     "cdyn_rollout": launches["cdyn_rollout"],
                     "cdyn_period_cm": cm_p_launches["cdyn_period_cm"],
                     "cdyn_rollout_cm": cm_launches["cdyn_rollout_cm"]}
    # Ops: the flat plain version's count (earlier phases) plus the terrain
    # branch's, counted on the plain version, for every contact evaluation
    nc = len(env.robot.contact_frame_indices)
    terrain_ops, n_hash, hash_emulated, hash_device = (
        waited(counts, "the terrain op counts") if counts is not None else rough_terrain_ops())
    n_sub = prun.n_substeps
    evals = {"cdyn_accel": 1, "cdyn_period": 4 * n_sub + 1,
             "cdyn_rollout": n_ticks * 4 * n_sub + 1,
             "cdyn_period_cm": 4 * n_sub + 1,
             "cdyn_rollout_cm": n_ticks * 4 * n_sub + (n_ticks - 1) + 1}
    log(f"[ops] the terrain branch on the plain version: {terrain_ops} ops a contact evaluation, "
        f"its {n_hash} lattice hashes counted as the device's {hash_device} multiplies (the "
        f"plain version's int64 emulation counts {hash_emulated}) ({nc} contacts; evaluations "
        f"a launch {evals})")
    lib = kernels.load()
    out = []
    for name, (kern, plain, xs) in inputs.items():
        xs, cut = tuple(x.contiguous() for x in xs), ROUGH_CUT[name]
        ms = _time_cuda(lambda: kern(*xs), n_time[name])
        ms_part = _time_cuda(lambda: kern(*xs, **cut), n_time[name]) if cut else None
        outs = kern(*xs, **cut)
        outs = outs if isinstance(outs, tuple) else (outs,)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs = plain(*xs, **cut)  # the same work as the launch timed as ms_part (ms uncut)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        refs = refs if isinstance(refs, tuple) else (refs,)
        e_abs = abs_err(outs, refs)
        e32, at32 = output_error(outs, refs, "float32")
        check(all(bool(torch.isfinite(o).all()) for o in outs), f"{name}: non-finite output")
        ops = flat[name]["ops_per_env"] + terrain_ops * nc * evals[name]
        t_ops = ops * B_MAIN / PEAK_F32_FLOPS * 1e3
        t_bytes = flat[name]["bytes_per_env"] * B_MAIN / PEAK_BYTES * 1e3
        if name.endswith("_cm"):
            smem4, _, per_sm = (cm_prun if name == "cdyn_period_cm" else cm_run).launch_geometry(
                device, torch.float32)
            smem = {4: smem4}
            per_sm_flat = flat[name]["envs_per_sm"]
        else:
            per_sm = lib.sp_envs_per_sm(name, 4, flat[name]["smem_per_env"], terrain=True)
            per_sm_flat = lib.sp_envs_per_sm(name, 4, flat[name]["smem_per_env"])
            smem = {4: flat[name]["smem_per_env"]}
        rec = {
            "name": name,
            "route": "cuda",
            "source": flat[name]["source"],
            "replaces": flat[name]["replaces"],
            "launches": main_launches[name],
            "max_abs_err": e_abs,
            "ms": ms,
            "plain_ms": None if cut else plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
            "model": "anymal-pid",
            "ground": "rough",
            "plain_ms_basis": ("measured" if not cut else
                               f"not measured: the plain version's whole launch was not run; "
                               f"over {cut} it took plain_ms_part, the kernel ms_part"),
            "cut_compared": cut or None,
            "ms_part": ms_part,
            "plain_ms_part": plain_ms if cut else None,
            "check_ticks": None,
            "ops_per_env": ops,
            "terrain_ops_per_contact": terrain_ops,
            "bytes_per_env": flat[name]["bytes_per_env"],
            "f32_q90_err_main": e32,
            "f64_err_check": errs[name]["float64"],
            "f32_q90_err_check": errs[name]["float32"],
            "smem_per_env": smem[4],
            "envs_per_sm": per_sm,
            "envs_per_sm_flat": per_sm_flat,
            "ms_flat": flat[name]["ms"],
            **({"env_steps_per_s": sps} if name == "cdyn_rollout" else {}),
            **({"env_steps_per_s": cm_sps} if name == "cdyn_rollout_cm" else {}),
            **({"witness": witness} if name == "cdyn_accel" else {}),
        }
        plain_txt = (f"plain {plain_ms:.1f} ms (measured)" if not cut else
                     f"over {cut} the kernel {ms_part:.4f} ms, the plain version {plain_ms:.1f} ms "
                     f"(host clock)")
        log(f"[kernel] anymal-pid rough {name} B={B_MAIN} float32: {ms:.4f} ms (CUDA events; "
            f"flat {flat[name]['ms']:.4f} ms, {ms / flat[name]['ms']:.2f}x), {plain_txt}, "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
            f"{rec['bound_ms'] / ms:.2%} of it; {smem[4]} B an env, {per_sm} envs an SM (flat "
            f"instance {per_sm_flat}); |kernel-plain| on the main path's states {e_abs:.3e}, {ERR_NAME['float32']} {e32:.3e} at "
            f"{at32}{f' over {cut}' if cut else ''}; launches {main_launches[name]} on {smi}")
        out.append(rec)
        del outs, refs
    log(f"[terrain] rough ground: spring-damper {sps:.1f} env-steps/s, constraint mode "
        f"{cm_sps:.1f} env-steps/s (flat: phase 4 and phase 7) on {smi}")
    return out, sps, cm_sps


# --------------------------------------------------------------------------- #
# Loop closures: Digit through the constrained kernels' extended body, Cassie
# on the generic path
# --------------------------------------------------------------------------- #

N_STEPS_DIGIT = 2  # digit-pid main path, after a warm-up
DIGIT_PLAIN_TICKS = 1  # digit-pid's rollout held to its plain version on the main path's states
B_LOOP_CHECK = 1024  # the loop robots' kernels held to their plain versions, small batch
LOOP_TICKS = 2  # rollout checks: whole ticks, the refresh solve between them
LOOP_SUBSTEPS = 1  # the cut checks: substeps a tick
PUSHROD_TOL = 0.02  # [m] |d - d_ref| of a pushrod (jiminy_tpu's tests/test_bipeds.py:28-46)
CASSIE_GOLDEN_ATOL = 1e-10  # the CPU test's tolerance of tests/goldens/cassie-pid.csv
N_STEPS_CASSIE = 1  # cassie-pid main path, after a warm-up
B_CASSIE = 32768  # cassie-pid main path's batch, cut so that the run fits its limit


def _digit_make(device, dtype, base=None):
    """digit-pid; with `base` (a digit-pid env) on the rough ground, with
    base's options otherwise."""
    from jiminy_torch.envs import make
    from jiminy_torch.testing import ground_options, rough_ground

    if base is None:
        return make("digit-pid", device=device, dtype=dtype)
    return make("digit-pid", device=device, dtype=dtype,
                options=ground_options(base.engine.options, rough_ground()))


def _loop_row(sim, dtype):
    """[distance_ref | lam | cact | bact] of a state: the tail of the command row."""
    import torch

    return torch.cat([sim.distance_ref, _cm_solver_row(sim, dtype)], dim=-1)


def _pushrod_error(env, sim):
    """Largest |d - d_ref| of a pushrod in each env (float64, forward
    kinematics of the port on the card)."""
    import torch

    from jiminy_torch.ops.kinematics import forward_kinematics, frame_placement

    model, cset = env.robot.model, env.engine.cset
    kin = forward_kinematics(model, sim.q.double())
    errs = []
    for k, (fa, fb) in enumerate(cset.distance_pairs):
        d = torch.linalg.norm(frame_placement(model, kin, fa)[1] - frame_placement(model, kin, fb)[1],
                              dim=-1)
        errs.append((d - sim.distance_ref[..., k].double()).abs())
    return torch.stack(errs, -1).amax(-1)


def _cm_registers(log_text, kernel, dtype_char, terrain, ext):
    """Registers of a constrained kernel instance from nvcc's -Xptxas -v log."""
    import re

    tag = f"{len(kernel) + 7}{kernel}_kernelI{dtype_char}Lb{int(terrain)}ELb{int(ext)}E"
    name = None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'|Function properties for (\S+)", line)
        if m:
            name = m.group(1) or m.group(2)
        m = re.search(r"Used (\d+) registers", line)
        if m and name and tag in name:
            return int(m.group(1))
    return None


def _cm_geometry_record(lib, device, run32, run64, name, terrain, ext):
    """The launch geometry of a constrained integrator's kernel at both
    dtypes (`launch_geometry`: bytes of shared memory an env, the envs a
    block the launcher picks, the envs an SM), and the float32 instance's
    registers from the build's -Xptxas -v log."""
    import torch

    g32 = run32.launch_geometry(device, torch.float32)
    g64 = run64.launch_geometry(device, torch.float64)
    check(g32[2] > 0 and g64[2] > 0, f"{name}: no block fits an SM")
    return {"smem_per_env": g32[0], "smem_per_env_f64": g64[0], "envs_per_block": g32[1],
            "envs_per_block_f64": g64[1], "envs_per_sm": g32[2], "envs_per_sm_f64": g64[2],
            "registers": _cm_registers(lib.build.ptxas_log, name, "f", terrain, ext)}


def _geometry_text(rec):
    return (f"{rec['registers']} registers, {rec['smem_per_env']} B an env "
            f"({rec['smem_per_env_f64']} at float64), {rec['envs_per_block']} envs a block and "
            f"{rec['envs_per_sm']} an SM ({rec['envs_per_block_f64']} and "
            f"{rec['envs_per_sm_f64']} at float64)")


def phase_digit_main_path(device, smi, model="digit-pid"):
    """digit-pid (or another loop robot of `_cm_env`: the procedural Cassie)
    at float32, B_MAIN: reset, a warm-up step, launch counts to 0,
    N_STEPS_DIGIT steps of zero actions, counts read; the pushrods, the
    finite state and (the Digit's) standing envs' base height; then one step
    of the per-period path."""
    import torch

    from jiminy_torch.ops import cdyn
    from jiminy_torch.pytree import leaves

    tag = "[digit]" if model == "digit-pid" else f"[{model}]"
    env = _cm_env(device, torch.float32, model)
    action = torch.zeros(env.action_size, device=device)
    t0 = time.perf_counter()
    st, _ = env.reset(batch_size=B_MAIN)
    torch.cuda.synchronize()
    reset_ms = (time.perf_counter() - t0) * 1e3
    st, *_ = env.step(st, action)  # warm-up
    torch.cuda.synchronize()
    cdyn.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(N_STEPS_DIGIT):
        st, obs, reward, term, trunc, _ = env.step(st, action)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    steps_per_s = B_MAIN * N_STEPS_DIGIT / elapsed
    log(f"{tag} {model} float32 B={B_MAIN}: reset {reset_ms:.1f} ms, {N_STEPS_DIGIT} steps "
        f"after a warm-up: {steps_per_s:.1f} env-steps/s ({elapsed / N_STEPS_DIGIT * 1e3:.1f} ms a "
        f"step, host clock), launches {launches} on {smi}")
    check(launches["cdyn_rollout_cm"] == N_STEPS_DIGIT and sum(launches.values()) == N_STEPS_DIGIT,
          f"{model} did not run cdyn_rollout_cm once a step (and nothing else)")
    sim = st.sim
    for name, x in (("q", sim.q), ("v", sim.v), ("reward", reward), ("lam", sim.lam),
                    ("contact_forces", sim.contact_forces), *enumerate(leaves(obs))):
        check(bool(torch.isfinite(x).all()), f"{model}: non-finite {name} on its main path")
    rod = _pushrod_error(env, sim)
    fell = term.bool()
    low = (sim.q[:, 2] <= env.env.base_height_min) & ~fell
    log(f"{tag} pushrods: max |d - d_ref| {float(rod.max()):.3e} m (tol {PUSHROD_TOL:g}); "
        f"terminated share {float(fell.float().mean()):.4f}; standing envs below base_height_min "
        f"{int(low.sum())}; base height {float(sim.q[:, 2].min()):.4f} .. "
        f"{float(sim.q[:, 2].max()):.4f} m; loop multipliers |lam| <= "
        f"{float(sim.lam.abs().max()):.3e}")
    check(float(rod.max()) < PUSHROD_TOL, f"a {model} pushrod drifted from its length")
    if model == "digit-pid":  # the procedural Cassie's stance is reported, not held
        check(not bool(low.any()), "a standing Digit env is below base_height_min")

    env.use_fused_rollout = False
    cdyn.reset_launch_counts()
    t0 = time.perf_counter()
    st2, *_ = env.step(st, action)
    torch.cuda.synchronize()
    pp_ms = (time.perf_counter() - t0) * 1e3
    period_launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    n_periods = env.env.n_ctrl_per_step
    log(f"{tag} per-period path, 1 step from the main path's state: {B_MAIN / pp_ms * 1e3:.1f} "
        f"env-steps/s, launches {period_launches}")
    check(period_launches["cdyn_period_cm"] == n_periods and sum(period_launches.values()) == n_periods,
          f"{model}'s per-period path did not run cdyn_period_cm once a period")
    check(bool(torch.isfinite(st2.sim.q).all()), f"non-finite q on {model}'s per-period path")
    check(float(_pushrod_error(env, st2.sim).max()) < PUSHROD_TOL, "a pushrod drifted (per period)")
    env.use_fused_rollout = True
    return env, launches, period_launches, steps_per_s, reset_ms, st, st2


def loop_op_counts(env_cpu, q, v, cc, bc, fold_zeros):
    """Ops per env of one constrained period and one env step of a robot with
    loop rows, counted on the plain version at B=1: period = substeps + the
    final solve; step = ticks x (controller + substeps) + the refreshes + the
    final solve."""
    import torch

    eng = env_cpu.engine
    qc, vc = [q[..., i] for i in range(q.shape[-1])], [v[..., i] for i in range(v.shape[-1])]
    ccl, bcl = [cc[..., i] for i in range(cc.shape[-1])], [bc[..., i] for i in range(bc.shape[-1])]
    run = eng._get_period_run("rk4")
    base, _, ctrl, _ = _step_controller(env_cpu)
    rrun = eng._get_rollout_run("count", ctrl, base.n_ctrl_per_step)
    acl = [torch.zeros(1, dtype=torch.float64)] * (env_cpu.action_size + eng.cset.n_distance
                                                   + eng.cset.n_rolling)

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


def phase_loop_checks(device, envs, procedural=None):
    """The constrained kernels against their plain versions at B_LOOP_CHECK
    on states from `testing.loop_inputs` (bases lowered 0-3 cm, joints and
    loop lengths perturbed, random warm starts and masks): digit-pid and
    jiminy_tpu's Cassie-shaped four-bar with a spring-damper foot and a
    penalty bound, each on flat and on rough ground (the flat and the
    terrain instances), both kernels. Float64 every column within 1e-9: the
    four-bar and the flat Digit over a whole period and LOOP_TICKS whole
    ticks, the Digit's zeroed loop multipliers and one PGS sweep refused, the
    rest at LOOP_TICKS x LOOP_SUBSTEPS; float32 within TOL at LOOP_TICKS x
    LOOP_SUBSTEPS; at float64 the rough cases' plain outputs
    must differ from the flat ones'. `envs` maps a dtype to its flat
    digit-pid env, `procedural` float64 to its procedural `cassie-pid` env,
    held as the rest at float64 (phase 27's perturbed states)."""
    import dataclasses

    import torch

    from jiminy_torch.engine import solver
    from jiminy_torch.engine.engine import Engine
    from jiminy_torch.ops import cdyn
    from jiminy_torch.testing import column_errors, fourbar_options, fourbar_robot
    from jiminy_torch.testing import ground_options, loop_inputs, rough_ground

    t_phase = time.perf_counter()
    cases = []
    for dtype in (torch.float64, torch.float32):
        flat = envs[dtype]
        q0 = flat.env.nominal_q.cpu().numpy()
        rough = _digit_make(device, dtype, base=flat)
        cases += [("digit flat", dtype, flat.engine, flat, q0),
                  ("digit rough", dtype, rough.engine, rough, q0)]
        for label, opts in (("four-bar flat", fourbar_options(True)),
                            ("four-bar rough", ground_options(fourbar_options(True),
                                                              rough_ground()))):
            eng = Engine(fourbar_robot(True), opts, device=device, dtype=dtype)
            cases.append((label, dtype, eng, None, [0.4, -0.3, 0.2]))
        if procedural is not None and dtype == torch.float64:
            env = procedural[dtype]
            cases.append(("cassie procedural", dtype, env.engine, env,
                          env.env.nominal_q.cpu().numpy()))
    errs, plain_refs = {}, {}
    for label, dtype, eng, env, q0 in cases:
        dname = "float64" if dtype == torch.float64 else "float32"
        q, v, cmd, tail = loop_inputs(eng, q0, B_LOOP_CHECK, seed=21, dtype=dtype)
        nd, nm = eng.cset.n_distance, eng.robot.nmotors
        n_solver = eng.cset.total_rows + eng.cset.n_contacts + eng.cset.n_bounds
        for name in ("cdyn_period_cm", "cdyn_rollout_cm"):
            before = cdyn.KERNELS[name].launches
            # float64: the four-bar and the flat Digit whole, the rest at the cut
            whole = dtype == torch.float64 and (env is None or label == "digit flat")
            if name == "cdyn_period_cm":
                run = eng._get_period_run("rk4")
                args = (q, v, torch.cat([cmd, tail], -1))
                cut = {} if whole else dict(n_substeps=LOOP_SUBSTEPS)
            else:
                if env is not None:
                    ctrl = env.block.component_controller(env.env)
                    block = torch.cat([q[:, 7:7 + nm], torch.zeros((B_LOOP_CHECK, 2 * nm),
                                                                   dtype=dtype, device=device)], -1)
                else:
                    ctrl = cdyn.ZOHPassThrough(nm)
                    block = torch.zeros((B_LOOP_CHECK, 0), dtype=dtype, device=device)
                run = eng._get_rollout_run("check", ctrl, 16)
                args = (q, v, torch.cat([cmd * 0.01, tail[:, :nd]], -1),
                        torch.cat([block, tail[:, nd:]], -1))
                cut = (dict(n_ticks=LOOP_TICKS) if whole else
                       dict(n_ticks=LOOP_TICKS, n_substeps=LOOP_SUBSTEPS))
            outs, refs = run.kernel(*args, **cut), replayed(run.plain)(*args, **cut)
            torch.cuda.synchronize()
            check(cdyn.KERNELS[name].launches == before + 1, f"{label} {name} did not launch once")
            e, at = output_error(outs, refs, dname)
            tol = TOL[dname][1]
            depth = {"n_substeps": run.n_substeps, **cut}
            witness = ""
            if label == "digit flat" and dtype == torch.float64:
                # the check refuses loop multipliers zeroed and a one-sweep solver
                n_extra = refs[2].shape[-1] - (0 if name == "cdyn_period_cm" else
                                               run.n_cmd + nd + 2 * n_solver + block.shape[-1])
                lam_cols = slice(n_extra - n_solver, n_extra - n_solver + nd)
                zeroed = outs[2].clone()
                zeroed[:, lam_cols] = 0.0
                e_zero = float(column_errors(zeroed, refs[2]).max())
                opts1 = dataclasses.replace(run.opts, iter_max=1)
                if name == "cdyn_period_cm":
                    one = solver.ConstrainedPeriodIntegrator(run.cd, run.tau_c, run.cset, opts1,
                                                             run.dt, run.n_substeps,
                                                             run.integrator, run.n_cmd,
                                                             run.imu_frames)
                else:
                    one = solver.ConstrainedRolloutIntegrator(run.cd, run.tau_c, run.cset, opts1,
                                                              run.dt, run.n_substeps, run.n_ticks,
                                                              ctrl, run.integrator,
                                                              run.imu_frames)
                e_sweep, _ = output_error(one.kernel(*args, **cut), refs, dname)
                witness = f"; witnesses: loop multipliers zeroed {e_zero:.3e}, one PGS sweep {e_sweep:.3e}"
                check(e_zero > tol and e_sweep > tol, f"digit {name}: the float64 check misses a wrong solver")
            flat_refs = plain_refs.setdefault((label.split()[0], name, dname), refs)
            if label.endswith("rough") and dtype == torch.float64:
                # the rough ground moves the outputs: the flat plain version's differ
                e_ground, _ = output_error(refs, flat_refs, dname)
                witness += f"; witness: the flat ground's plain outputs {e_ground:.3e} off"
                check(e_ground > tol, f"{label} {name}: the ground makes no difference")
            log(f"[loop-check] {label} {name} {dname} B={B_LOOP_CHECK} ({depth}): "
                f"{ERR_NAME[dname]} {e:.3e} at {at} (tol {tol:g}); max abs err "
                f"{abs_err(outs, refs):.3e}{witness}")
            check(all(bool(torch.isfinite(o).all()) for o in outs), f"{label} {name}: non-finite")
            check(e < tol, f"{label} {name} {dname} disagrees with its plain version: {e}")
            errs[(label, name, dname)] = e
    log(f"[loop-check] phase {time.perf_counter() - t_phase:.1f} s")
    return errs


def cassie_golden(device):
    """Every row of tests/goldens/cassie-pid.csv through cassie-pid on the
    card at float64, B=1, on the generic path (a CUDA graph a tick): (row
    count, largest |port - golden|, kernel launches, whether the env took the
    generic path, seconds). It launches no kernel and times nothing, so
    main() runs it in a process of its own beside phase 16."""
    import numpy as np
    import torch

    from jiminy_torch.envs import make
    from jiminy_torch.ops import cdyn

    golden = np.loadtxt(os.path.join(ROOT, "tests", "goldens", "cassie-pid.csv"), delimiter=",",
                        skiprows=1)
    env = make("cassie-pid", device=device, dtype=torch.float64)
    generic = env.engine._cdyn is None and env.engine._cdyn_cm is None
    st, _ = env.reset(batch_size=1)
    action = torch.zeros(env.action_size, dtype=torch.float64, device=device)
    cdyn.reset_launch_counts()
    t0 = time.perf_counter()
    worst = 0.0
    for k in range(len(golden)):
        st, _, rew, *_ = env.step(st, action)
        worst = max(worst, float(np.abs(_golden_row(st.sim, rew, 0) - golden[k]).max()))
    elapsed = time.perf_counter() - t0
    launches = sum(c.launches for c in cdyn.KERNELS.values())
    return len(golden), worst, launches, generic, elapsed


def phase_cassie(device, smi, golden=None):
    """cassie-pid on the generic path (its ankles are continuous joints: no
    kernel covers them), a CUDA graph a tick: every row of
    tests/goldens/cassie-pid.csv at float64, B=1, within the CPU test's
    tolerance (`golden`, a future of `cassie_golden()`; run here without
    it); then the throughput at float32, B_CASSIE, a warm-up and
    N_STEPS_CASSIE steps. It runs no kernel, and the line says so."""
    import torch

    from jiminy_torch.envs import make
    from jiminy_torch.ops import cdyn
    from jiminy_torch.pytree import leaves

    n_rows, worst, launches, generic, elapsed = (golden.result() if golden is not None else
                                                 cassie_golden(device))
    log(f"[cassie golden] cassie-pid float64 B=1, generic path (a CUDA graph a tick; in a process "
        f"of its own beside phase 16): {n_rows} rows, max abs err {worst:.3e} (tol "
        f"{CASSIE_GOLDEN_ATOL:g}), kernel launches {launches}, {elapsed:.1f} s")
    check(generic, "cassie-pid left the generic path")
    check(worst < CASSIE_GOLDEN_ATOL, "cassie-pid golden rows not reproduced on the card")
    check(launches == 0, "cassie-pid launched a kernel on the generic path")

    env32 = make("cassie-pid", device=device)
    action = torch.zeros(env32.action_size, device=device)
    st, _ = env32.reset(batch_size=B_CASSIE)
    st, *_ = env32.step(st, action)  # warm-up (the tick's CUDA graph is captured here)
    torch.cuda.synchronize()
    cdyn.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(N_STEPS_CASSIE):
        st, obs, reward, term, *_ = env32.step(st, action)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = sum(c.launches for c in cdyn.KERNELS.values())
    steps_per_s = B_CASSIE * N_STEPS_CASSIE / elapsed
    rod = _pushrod_error(env32, st.sim)
    log(f"[cassie] cassie-pid float32 B={B_CASSIE}, generic path (no kernel: continuous ankles), "
        f"{N_STEPS_CASSIE} steps after a warm-up: {steps_per_s:.1f} env-steps/s "
        f"({elapsed / N_STEPS_CASSIE * 1e3:.1f} ms a step, host clock), kernel launches "
        f"{launches}, terminated share {float(term.float().mean()):.4f}, pushrods max |d - d_ref| "
        f"{float(rod.max()):.3e} m on {smi}")
    for name, x in (("q", st.sim.q), ("v", st.sim.v), ("reward", reward), *enumerate(leaves(obs))):
        check(bool(torch.isfinite(x).all()), f"cassie-pid: non-finite {name}")
    check(launches == 0, "cassie-pid launched a kernel")
    check(float(rod.max()) < PUSHROD_TOL, "a Cassie pushrod drifted from its length")
    return steps_per_s




# --------------------------------------------------------------------------- #
# The ant (sphere contacts through the spring kernels and as PGS rows) and
# the rolling ball (rolling rows through the constrained kernels)
# --------------------------------------------------------------------------- #

N_STEPS_ANT = 5  # the ant's main path, after a warm-up step
N_STEPS_ANT_CM = 3  # the ant's main path in constraint mode, after a warm-up step
ANT_CHECK_TICKS = 2  # the ant's spring rollout held to its plain version over these ticks (of 10)
ANT_CM_TICKS = 1  # its cdyn_rollout_cm held and timed against its plain version over these
B_ANT_ROUGH_CHECK = 1024  # the terrain instance with radii, against its plain version
N_STEPS_BALL = 200  # steps of 1 ms of the rolling ball at B_MAIN
B_BALL_CHECK = 256  # the ball's cdyn_period_cm against its plain version at float64
N_STEPS_BALL_CHECK = 150
BALL_RADIUS = 0.2
BALL_SLIP_TOL = 1e-4  # [m/s] |v_x - w_y r| (jiminy_tpu's tests/test_rolling.py:31-61)
BALL_HEIGHT_TOL = 1e-3  # [m]
BALL_TRAVEL_MIN = 0.015  # [m] over N_STEPS_BALL steps from a spin of 2-3 rad/s


def _ant_make(device, dtype, constraint=False, rough=False, bounds=None):
    """make("ant") (spring-damper), in constraint contact mode, on the rough
    ground, or with `joint_bounds_mode=bounds`."""
    from jiminy_torch.engine.config import ContactModel
    from jiminy_torch.envs import make
    from jiminy_torch.testing import ground_options, rough_ground

    kw = {"contact_model": ContactModel.CONSTRAINT} if constraint else {}
    env = make("ant", device=device, dtype=dtype, **kw)
    options = env.engine.options
    if rough:
        options = ground_options(options, rough_ground())
    if bounds:
        options = options.replace(joint_bounds_mode=bounds)
    if rough or bounds:
        env = make("ant", device=device, dtype=dtype, options=options)
    return env


def _limited_joints(robot):
    """The motorized 1-dof joints with finite limits (the ant's eight)."""
    import numpy as np

    model = robot.model
    lo, hi = np.asarray(model.position_limit_lower), np.asarray(model.position_limit_upper)
    return [j for j in robot.motors.joint_indices
            if np.isfinite(lo[model.idx_q[j]]) or np.isfinite(hi[model.idx_q[j]])]


def phase_ant_main_path(device, smi, constraint):
    """make("ant") at float32, B_MAIN, spring-damper or constraint contact
    mode: launch counts to 0, batched reset (cdyn_accel; in constraint mode
    the plain constrained solve, timed), a warm-up step and N steps of zero
    actions (one rollout launch a step, nothing else), counts read;
    env-steps/s, all finite, no standing ant terminated (constraint mode:
    phase 7's physics checks, every limited joint held); then one step of
    the per-period path (one period launch a controller period)."""
    import torch

    from jiminy_torch.ops import cdyn

    env = _ant_make(device, torch.float32, constraint)
    eng = env.engine
    tag = "ant-cm" if constraint else "ant"
    rollout, period = ("cdyn_rollout_cm", "cdyn_period_cm") if constraint else (
        "cdyn_rollout", "cdyn_period")
    n_steps = N_STEPS_ANT_CM if constraint else N_STEPS_ANT
    log(f"[{tag}] ant: nq {env.robot.nq}, nv {env.robot.nv}, {env.robot.model.njoints} joints, "
        f"{env.robot.nmotors} motors, contact radii {env.robot.contact_radii}, "
        f"{env.n_ctrl_per_step} ticks x {eng.n_substeps} substeps a step; rows "
        f"{eng.cset.total_rows} ({eng.cset.n_contacts} contacts, {eng.cset.n_bounds} bounds)")
    action = torch.zeros(env.action_size, device=device)
    cdyn.reset_launch_counts()
    t0 = time.perf_counter()
    st, _ = env.reset(batch_size=B_MAIN)
    torch.cuda.synchronize()
    reset_ms = (time.perf_counter() - t0) * 1e3
    st, *_ = env.step(st, action)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        st, obs, reward, term, trunc, _ = env.step(st, action)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    log(f"[{tag}] float32 B={B_MAIN}, reset ({reset_ms:.1f} ms, host clock) + warm-up + "
        f"{n_steps} steps: launches {launches}")
    want = {rollout: n_steps + 1, **({} if constraint else {"cdyn_accel": 1})}
    check(launches == {k: want.get(k, 0) for k in launches},
          f"{tag}: {rollout} not once a step (and {'nothing' if constraint else 'cdyn_accel'} "
          f"at the reset)")
    sim = st.sim
    for name, x in (("q", sim.q), ("v", sim.v), ("reward", reward),
                    ("contact_forces", sim.contact_forces)):
        check(bool(torch.isfinite(x).all()), f"{tag}: non-finite {name} on the main path")
    fell = float(term.float().mean())
    steps_per_s = B_MAIN * n_steps / elapsed
    log(f"[{tag}] base height mean {float(sim.q[:, 2].mean()):.4f} m, terminated share {fell:.4f}; "
        f"env-steps/s {steps_per_s:.1f} ({elapsed:.4f} s for {n_steps} steps, host clock) on {smi}")
    check(fell == 0.0, f"{tag}: a standing ant terminated under zero actions")
    if constraint:
        check(bool(torch.isfinite(sim.lam).all()), f"{tag}: non-finite multipliers")
        physics_checks(env, sim, joints=_limited_joints(env.robot))

    env.use_fused_rollout = False
    st2, *_ = env.step(st, action)
    torch.cuda.synchronize()
    cdyn.reset_launch_counts()
    t0 = time.perf_counter()
    st2, *_ = env.step(st2, action)
    torch.cuda.synchronize()
    elapsed_pp = time.perf_counter() - t0
    period_launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    pp_steps_per_s = B_MAIN / elapsed_pp
    log(f"[{tag}] per-period path, 1 step: launches {period_launches}; env-steps/s "
        f"{pp_steps_per_s:.1f} on {smi}")
    check(period_launches[period] == env.n_ctrl_per_step
          and sum(period_launches.values()) == env.n_ctrl_per_step,
          f"{tag}: {period} did not run once per controller period (and nothing else)")
    check(bool(torch.isfinite(st2.sim.q).all()), f"{tag}: non-finite q on the per-period path")
    env.use_fused_rollout = True
    return env, launches, period_launches, steps_per_s, pp_steps_per_s, reset_ms, st, st2


def phase_ant_rough_check(device):
    """The constrained kernels' terrain instance with sphere radii: the ant
    in constraint mode on the rough ground, B_ANT_ROUGH_CHECK states from
    `constrained_inputs` spread over the ground, float64: the whole period
    and the rollout over one tick, every column within 1e-9; the flat
    instance on the same states must miss the rough plain version."""
    import torch

    from jiminy_torch.ops import cdyn
    from jiminy_torch.testing import constrained_inputs, spread_on_ground

    dtype = torch.float64
    flat = _ant_make(device, dtype, constraint=True)
    rough = _ant_make(device, dtype, constraint=True, rough=True)
    ground = rough.engine.ground_fn
    nm = rough.robot.nmotors
    q, v, cmd, sol = constrained_inputs(rough, B_ANT_ROUGH_CHECK, seed=31, dtype=dtype)
    q = spread_on_ground(q, ground, seed=31, half_width=ROUGH_HALF_WIDTH)
    tol = TOL["float64"][1]
    errs = {}
    for name in ("cdyn_period_cm", "cdyn_rollout_cm"):
        runs = []
        for env in (rough, flat):
            eng = env.engine
            if name == "cdyn_period_cm":
                runs.append(eng._get_period_run("rk4"))
                args, cut = (q, v, torch.cat([cmd, sol], -1)), {}
            else:
                run = eng._get_rollout_run("rough-check", cdyn.ZOHPassThrough(nm),
                                           env.n_ctrl_per_step)
                runs.append(run)
                args, cut = (q, v, cmd * 0.05, sol), dict(n_ticks=1)
        before = cdyn.KERNELS[name].launches
        outs, refs = runs[0].kernel(*args, **cut), replayed(runs[0].plain)(*args, **cut)
        outs_flat = runs[1].kernel(*args, **cut)
        torch.cuda.synchronize()
        check(cdyn.KERNELS[name].launches == before + 2, f"ant rough {name} did not launch")
        e, at = output_error(outs, refs, "float64")
        e_flat, _ = output_error(outs_flat, refs, "float64")
        log(f"[ant-rough] {name} float64 B={B_ANT_ROUGH_CHECK} "
            f"({'1 tick' if cut else 'a whole period'}): {ERR_NAME['float64']} {e:.3e} at {at} "
            f"(tol {tol:g}); witness: the flat instance against the rough plain version "
            f"{e_flat:.3e}")
        check(all(bool(torch.isfinite(o).all()) for o in outs) and e < tol,
              f"ant rough {name} disagrees with its plain version: {e}")
        check(e_flat > tol, f"ant rough {name}: the flat instance passes the terrain check")
        errs[name] = e
    return errs


def _ball_engine(device, dtype, kind):
    """jiminy_tpu's tests/test_rolling.py ball: a free body of radius
    BALL_RADIUS (mass 1, solid-sphere inertia), a sphere or a wheel (axis
    y) rolling constraint on its centre frame, RK4 at 1 ms."""
    import numpy as np

    from jiminy_torch.engine.config import EngineOptions, StepperOptions
    from jiminy_torch.engine.engine import Engine
    from jiminy_torch.engine.robot import Robot
    from jiminy_torch.models import build_model
    from jiminy_torch.models.joints import JointType

    model = build_model(
        "ball",
        [{"name": "root_joint", "type": JointType.FREE, "parent": -1, "mass": 1.0,
          "com": np.zeros(3), "inertia": np.eye(3) * (2.0 / 5.0) * BALL_RADIUS**2}],
        [{"name": "center", "parent": 0, "placement": (np.eye(3), np.zeros(3))}])
    spec = {"frame_name": "center", "radius": BALL_RADIUS}
    if kind == "wheel":
        spec["axis"] = (0.0, 1.0, 0.0)
    robot = Robot.build(model, rolling_constraints=[spec])
    return Engine(robot, EngineOptions(stepper=StepperOptions(dt_max=1e-3)), device=device,
                  dtype=dtype)


def _ball_periods(eng, st, n, route):
    """`n` controller periods of `eng` from `st` through the period
    integrator's kernel or plain version (`route`), as `Engine.step` runs
    them: (q, v, lam) after them."""
    import torch

    from jiminy_torch.ops import integrate as integ

    run = eng._get_period_run("rk4")
    fn = run.kernel if route == "kernel" else replayed(run.plain)
    q, v, lam = st.q, st.v, st.lam
    dt = q.dtype
    for _ in range(n):
        cc = torch.cat([st.command, st.distance_ref, lam, st.contact_active.to(dt),
                        st.bound_active.to(dt), st.rolling_ref], -1)
        q, v, extras = fn(q, v, cc)
        q = integ.normalize(eng.robot.model, q)
        _, aux = eng._unpack_period_extras(extras, st.command, v, *eng._solver_widths())
        lam = aux["lam"]
    return q, v, lam


def phase_ball_checks(device):
    """Phase 24's float64 check for each spec: cdyn_period_cm and its plain
    version over N_STEPS_BALL_CHECK periods each way from B_BALL_CHECK
    tilted balls with random velocities and reference heights, q, v and the
    multipliers within 1e-9 of their columns, zeroed multipliers refused.
    Returns kind -> (error, where, the zeroed multipliers' error)."""
    import torch

    from jiminy_torch.ops import cdyn

    out = {}
    for kind in ("sphere", "wheel"):
        eng64 = _ball_engine(device, torch.float64, kind)
        gen = torch.Generator(device=device).manual_seed(8)
        qb = torch.zeros((B_BALL_CHECK, 7), dtype=torch.float64, device=device)
        w = torch.randn((B_BALL_CHECK, 3), generator=gen, device=device, dtype=torch.float64) * 0.5
        th = torch.linalg.norm(w, dim=1, keepdim=True)
        qb[:, 3:6], qb[:, 6:] = w / th * torch.sin(th / 2), torch.cos(th / 2)
        qb[:, :3] = torch.randn((B_BALL_CHECK, 3), generator=gen, device=device,
                                dtype=torch.float64) * 0.01
        qb[:, 2] += BALL_RADIUS
        vb = torch.randn((B_BALL_CHECK, 6), generator=gen, device=device, dtype=torch.float64)
        stb = eng64.reset(qb, vb)
        stb = stb.replace(rolling_ref=stb.rolling_ref + 0.003 * torch.randn(
            (B_BALL_CHECK, 1), generator=gen, device=device, dtype=torch.float64))
        before = cdyn.KERNELS["cdyn_period_cm"].launches
        got = _ball_periods(eng64, stb, N_STEPS_BALL_CHECK, "kernel")
        want = _ball_periods(eng64, stb, N_STEPS_BALL_CHECK, "plain")
        torch.cuda.synchronize()
        check(cdyn.KERNELS["cdyn_period_cm"].launches == before + N_STEPS_BALL_CHECK,
              f"ball {kind}: the float64 check did not launch once a period")
        e64, at64 = output_error(got, want, "float64")
        e_zero, _ = output_error((got[0], got[1], torch.zeros_like(got[2])), want, "float64")
        log(f"[ball] {kind} cdyn_period_cm float64 B={B_BALL_CHECK}, {N_STEPS_BALL_CHECK} periods "
            f"each way: q, v, lam column max rel err {e64:.3e} at {at64} (tol "
            f"{TOL['float64'][1]:g}); zeroed multipliers {e_zero:.3e}")
        check(e64 < TOL["float64"][1], f"ball {kind}: float64 kernel and plain trajectories part")
        check(e_zero > TOL["float64"][1], f"ball {kind}: the check passes zeroed multipliers")
        out[kind] = (e64, at64, e_zero)
    return out


def phase_ball(device, smi, checks, counts=None):
    """The rolling ball through cdyn_period_cm (a sphere spec and a wheel
    spec): B_MAIN balls at float32, spun about y at 2-3 rad/s (a seeded
    torch.Generator), launch counts to 0, N_STEPS_BALL steps of 1 ms (one
    launch a step, nothing else), counts read; checked as jiminy_tpu's
    tests/test_rolling.py:31-61 checks one ball: no slip, the height kept,
    the speed of the momentum kept about the contact point, the ball
    travelled. `checks` are `phase_ball_checks`'s float64 numbers, `counts`
    futures of `_ball_ops`. Records for the kernels line."""
    import torch

    from jiminy_torch.ops import cdyn, lie

    records, rates = [], {}
    for kind in ("sphere", "wheel"):
        eng = _ball_engine(device, torch.float32, kind)
        check(eng.cset.n_rolling == 1 and eng.cset.total_rows == 3, f"ball {kind}: not 3 rows")
        gen = torch.Generator(device=device).manual_seed(7)
        q0 = torch.tensor([0.0, 0.0, BALL_RADIUS, 0.0, 0.0, 0.0, 1.0], device=device)
        q0 = q0.expand(B_MAIN, 7).contiguous()
        w0 = 2.0 + torch.rand(B_MAIN, generator=gen, device=device)
        v0 = torch.zeros((B_MAIN, 6), device=device)
        v0[:, 4] = w0
        st = eng.reset(q0, v0)
        torch.cuda.synchronize()
        cdyn.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(N_STEPS_BALL):
            st = eng.step(st)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
        log(f"[ball] {kind} float32 B={B_MAIN}, {N_STEPS_BALL} steps of 1 ms: launches {launches}")
        check(launches["cdyn_period_cm"] == N_STEPS_BALL and sum(launches.values()) == N_STEPS_BALL,
              f"ball {kind}: cdyn_period_cm not once a step (and nothing else)")
        for name, x in (("q", st.q), ("v", st.v), ("lam", st.lam)):
            check(bool(torch.isfinite(x).all()), f"ball {kind}: non-finite {name}")
        q, v = st.q.double(), st.v.double()
        rot = lie.quat_to_mat(q[:, 3:7])
        v_w, w_w = lie.mv(rot, v[:, :3]), lie.mv(rot, v[:, 3:6])
        slip = float((v_w[:, 0] - w_w[:, 1] * BALL_RADIUS).abs().max())
        v_expected = 0.4 / 1.4 * w0.double() * BALL_RADIUS  # I / (I + m r^2) w0 r
        speed = float(((v_w[:, 0] - v_expected).abs() / (0.25 * v_expected + 1e-3)).max())
        height = float((q[:, 2] - BALL_RADIUS).abs().max())
        travel = float(q[:, 0].min())
        rates[kind] = B_MAIN * N_STEPS_BALL / elapsed
        log(f"[ball] {kind}: max slip |v_x - w_y r| {slip:.3e} m/s (tol {BALL_SLIP_TOL:g}), max "
            f"|v_x - v_expected| / (0.25 v_expected + 1e-3) {speed:.3f} (at most 1), max |z - r| "
            f"{height:.3e} m (tol {BALL_HEIGHT_TOL:g}), least x travelled {travel:.4f} m (at least "
            f"{BALL_TRAVEL_MIN:g}); env-steps/s {rates[kind]:.1f} ({elapsed:.3f} s, host clock) "
            f"on {smi}")
        check(slip < BALL_SLIP_TOL, f"ball {kind}: it slips")
        check(speed <= 1.0, f"ball {kind}: the rolling speed is off")
        check(height < BALL_HEIGHT_TOL, f"ball {kind}: it left its height")
        check(travel > BALL_TRAVEL_MIN, f"ball {kind}: it did not travel")

        # one launch at B_MAIN: kernel (CUDA events) and plain (host clock)
        run = eng._get_period_run("rk4")
        cc = torch.cat([st.command, st.distance_ref, st.lam, st.contact_active.float(),
                        st.bound_active.float(), st.rolling_ref], -1)
        ms = _time_cuda(lambda: run.kernel(st.q, st.v, cc), 20)
        outs = run.kernel(st.q, st.v, cc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs = replayed(run.plain)(st.q, st.v, cc)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        e_abs = abs_err(outs, refs)
        e32, at32 = output_error(outs, refs, "float32")

        e64 = checks[kind][0]
        ops = waited(counts[kind], f"the {kind} ball's op counts") if counts else _ball_ops(kind)
        nq, nv, n = 7, 6, 3
        io = 2 * nq + 2 * nv + (n + 1) + (nv + n)  # q v in and out, cc row, extras
        t_ops = ops * B_MAIN / PEAK_F32_FLOPS * 1e3
        t_bytes = io * 4 * B_MAIN / PEAK_BYTES * 1e3
        rec = {
            "name": "cdyn_period_cm", "route": "cuda", "source": "jiminy_torch/csrc/pgs.cuh",
            "replaces": cdyn.KERNELS["cdyn_period_cm"].replaces.split()[0],
            "launches": launches["cdyn_period_cm"], "max_abs_err": e_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
            "model": f"ball ({kind})", "ops_per_env": ops, "bytes_per_env": io * 4,
            "f32_q90_err_main": e32, "f64_err_trajectory": e64, "env_steps_per_s": rates[kind],
        }
        log(f"[kernel] ball ({kind}) cdyn_period_cm B={B_MAIN} float32: {ms:.4f} ms (CUDA events), "
            f"plain {plain_ms:.1f} ms (host clock), bound {rec['bound_ms']:.5f} ms "
            f"({rec['bound_by']}; {ops} ops and {io * 4} B an env), {rec['bound_ms'] / ms:.2%} of "
            f"it; float32 {ERR_NAME['float32']} {e32:.3e} at {at32} (printed); launches "
            f"{rec['launches']} on {smi}")
        records.append(rec)
    return records, rates


def _ball_ops(kind):
    """Scalar ops per env of one ball period (one RK4 substep and the final
    solve), counted on the plain version on the CPU at B=1, zero operands
    folded away."""
    import torch

    eng = _ball_engine("cpu", torch.float64, kind)
    q0 = torch.tensor([[0.0, 0.0, BALL_RADIUS, 0.0, 0.0, 0.0, 1.0]], dtype=torch.float64)
    v0 = torch.tensor([[0.1, 0.0, 0.0, 0.0, 2.0, 0.0]], dtype=torch.float64)
    st = eng.reset(q0, v0)
    run = eng._get_period_run("rk4")
    cc = torch.cat([st.command, st.distance_ref, st.lam, st.contact_active.double(),
                    st.bound_active.double(), st.rolling_ref], -1)
    return count_elem_ops(lambda: run.plain(st.q, st.v, cc), True)


# --------------------------------------------------------------------------- #
# The Atlas in constraint mode and the ant with its bounds as rows: the
# constrained kernels at 44 to 78 rows and nv up to 36 (phase 25)
# --------------------------------------------------------------------------- #

B_CM_WIDE = 8192  # their main path's batch, cut so that the phase fits (the models' full width)
N_STEPS_CM_WIDE = 1  # timed steps, after a warm-up step (cut from 2 so that the run fits)
# their kernels held and timed against the plain version over one substep of
# the period and one tick of one substep of the rollout (a plain atlas-pid
# solve is some 1 s of replayed launches)
CM_WIDE_CUT = {"cdyn_period_cm": dict(n_substeps=1), "cdyn_rollout_cm": dict(n_ticks=1, n_substeps=1)}
B_CM_ROWS = 1024  # their perturbed, every-row and no-row states
CM_REG_ROWS = 40  # rows whose sweep state the kernels keep in registers (csrc/pgs.cuh)
CM_WIDE_MODELS = ("atlas-pid", "atlas-reduced-pid", "ant-bounds")


def _cm_env(device, dtype, model):
    """A constrained model of phases 19, 23, 25 and 27 (CM_CASES): digit-pid,
    the procedural Cassie ("cassie-procedural", `cassie-pid` with
    `procedural=True`), the ant in constraint contact mode ("ant"; "ant-bounds" with its joint
    bounds as rows too), or an Atlas env id in constraint mode
    (`testing.constraint_mode_options`: ground contacts and joint bounds as
    PGS rows)."""
    from jiminy_torch.envs import make
    from jiminy_torch.testing import constraint_mode_options

    if model == "digit-pid":
        return _digit_make(device, dtype)
    if model == "cassie-procedural":
        return make("cassie-pid", device=device, dtype=dtype, procedural=True)
    if model in ("ant", "ant-bounds"):
        return _ant_make(device, dtype, constraint=True,
                         bounds="constraint" if model == "ant-bounds" else None)
    options = make(model, device=device, dtype=dtype).engine.options
    return make(model, device=device, dtype=dtype, options=constraint_mode_options(options))


def cm_model_op_counts(model, q1, v1, cc1, bc1):
    """`loop_op_counts` of a CM_CASES model on the CPU at one state, zero
    operands folded away."""
    import torch

    return loop_op_counts(_cm_env("cpu", torch.float64, model), q1, v1, cc1, bc1, fold_zeros=True)


@dataclasses.dataclass(frozen=True)
class CmCase:
    """How `phase_cm_records` holds a model's two constrained kernels."""
    label: str  # the records' "model"
    cuts: dict  # kernel -> the cut its plain version runs ({}: the whole launch)
    reps: tuple  # CUDA-event repetitions: the period whole, the rollout whole, a cut
    f64: tuple  # the kernels held at float64 on the main path's states
    ext: bool  # the model takes the kernels' extended body (`solver.cm_ext`)
    extra_rows: tuple = ()  # `constrained_inputs` states after the main path's envs
    replay: bool = True  # the plain version's substeps replayed from CUDA graphs


CM_KERNELS = ("cdyn_period_cm", "cdyn_rollout_cm")
CM_ROW_STATES = ("mixed", "all", "none")  # a quarter past a bound; every row active; none
CM_CASES = {
    # phase 20 holds the Digit's whole period and whole ticks at float64
    "digit-pid": CmCase("digit-pid", {"cdyn_period_cm": dict(n_substeps=1),
                                      "cdyn_rollout_cm": dict(n_ticks=DIGIT_PLAIN_TICKS)},
                        (5, 1, 5), ("cdyn_period_cm",), True),
    # the procedural Cassie's perturbed states are held in phase 20's loop checks
    "cassie-procedural": CmCase("cassie-pid (procedural)", CM_WIDE_CUT, (3, 1, 3),
                                ("cdyn_rollout_cm",), True),
    "ant": CmCase("ant (constraint mode)", {"cdyn_period_cm": {},
                                            "cdyn_rollout_cm": dict(n_ticks=ANT_CM_TICKS)},
                  (5, 1, 3), CM_KERNELS, True),
    "atlas-pid": CmCase("atlas-pid (constraint mode)", CM_WIDE_CUT, (3, 1, 2), CM_KERNELS, False,
                        CM_ROW_STATES, False),
    "atlas-reduced-pid": CmCase("atlas-reduced-pid (constraint mode)", CM_WIDE_CUT, (3, 1, 2),
                                CM_KERNELS, False, CM_ROW_STATES, False),
    "ant-bounds": CmCase("ant (constraint mode, bounds as rows)", CM_WIDE_CUT, (3, 1, 2),
                         CM_KERNELS, True, CM_ROW_STATES, False),
}


def cm_count_args(model, env, st):
    """`cm_model_op_counts`'s arguments for `model` at its main path's state
    `st` (the rollout's): env 0's q, v, command row and carry row, float64
    on the CPU."""
    import torch

    B, nm = st.sim.q.shape[0], env.robot.nmotors
    carry = torch.cat([_step_controller(env)[3](st), _cm_solver_row(st.sim, torch.float32)], -1)
    cc = torch.cat([st.sim.command.expand(B, nm), _loop_row(st.sim, torch.float32)], -1)
    return tuple([model] + [x[:1].double().cpu() for x in (st.sim.q, st.sim.v, cc, carry)])


def phase_cm_records(model, env, launches, period_launches, smi, st, st2, counters=None,
                     env64=None, counting=None):
    """The two constrained kernels of `model` (CM_CASES) on its main path's
    states `st` (the rollout's) and `st2` (the period's), float32, B their
    batch. Each kernel timed (CUDA events) over its whole launch and, beside
    its plain version (host clock), over the case's cut (`plain_ms` null
    where the cut is not the whole launch). Float32: the main path's envs
    printed beside a one-ulp witness (the kernel against itself with q moved
    one ulp), and with the kernels of `case.f64` the float32 kernel and
    plain version each against the float64 plain version; the perturbed
    `constrained_inputs` states of `case.extra_rows` (after the main path's
    envs, in the same calls) held to TOL. Float64 (the kernels of
    `case.f64`): the main path's envs one short (the last block
    part-filled), then the other row states, every column within 1e-9,
    zeroed multipliers and one PGS sweep refused, every row active and none
    active as their states say. Ops counted on the plain version (`counting`,
    a worker's count started earlier; else in a worker of `counters`, or
    here), bytes, bound, registers, shared memory, envs a block and an SM; a
    record each for the kernels line."""
    import torch

    from jiminy_torch.engine import solver
    from jiminy_torch.ops import cdyn, kernels
    from jiminy_torch.testing import column_errors, constrained_inputs

    case = CM_CASES[model]
    device = env.device
    tag = f"[{model}-cm-check]"
    env64 = env64 or _cm_env(device, torch.float64, model)
    carry_of = _step_controller(env)[3]
    nm = env.robot.nmotors
    cset = env.engine.cset
    B = st.sim.q.shape[0]

    def run_of(name, e, opts=None):
        if name == "cdyn_period_cm":
            run = e.engine._get_period_run("rk4")
            if opts is not None:
                run = solver.ConstrainedPeriodIntegrator(run.cd, run.tau_c, run.cset, opts, run.dt,
                                                         run.n_substeps, run.integrator,
                                                         run.n_cmd, run.imu_frames)
            return run
        base, k, ctrl, _ = _step_controller(e)
        run = e.engine._get_rollout_run(k, ctrl, base.n_ctrl_per_step)
        if opts is not None:
            run = solver.ConstrainedRolloutIntegrator(run.cd, run.tau_c, run.cset, opts, run.dt,
                                                      run.n_substeps, run.n_ticks, ctrl,
                                                      run.integrator, run.imu_frames)
        return run

    main_inputs = {
        "cdyn_period_cm": (st2.sim.q, st2.sim.v,
                           torch.cat([st2.sim.command.expand(B, nm),
                                      _loop_row(st2.sim, torch.float32)], -1)),
        "cdyn_rollout_cm": (st.sim.q, st.sim.v,
                            torch.cat([torch.zeros((B, nm), device=device),
                                       st.sim.distance_ref], -1),
                            torch.cat([carry_of(st), _cm_solver_row(st.sim, torch.float32)], -1)),
    }
    xs = main_inputs["cdyn_rollout_cm"]
    args = cm_count_args(model, env, st)
    if counting is None and counters:
        counting = counters.submit(cm_model_op_counts, *args)
    n_block = xs[3].shape[-1] - cset.total_rows - cset.n_contacts - cset.n_bounds
    extra, n_extra = {}, {}  # rows -> kernel -> float64 inputs
    for rows in case.extra_rows:
        qa, va, cmda, sola = constrained_inputs(env64, B_CM_ROWS, seed=41, rows=rows)
        blk = torch.zeros((B_CM_ROWS, n_block), dtype=torch.float64, device=device)
        blk[:, :min(nm, n_block)] = qa[:, 7:7 + min(nm, n_block)]
        extra[rows] = {"cdyn_period_cm": (qa, va, torch.cat([cmda, sola], -1)),
                       "cdyn_rollout_cm": (qa, va, cmda * 2.5, torch.cat([blk, sola], -1))}

    def joined(name, first, parts, dtype):
        """The main path's inputs `first` then those of `parts` (row states)
        for kernel `name`, at `dtype`, and each part's slice of the batch."""
        ys, at = [x.to(dtype) for x in first], first[0].shape[0]
        spans = {"main": slice(0, at)}
        for rows in parts:
            zs = extra[rows][name]
            ys = [torch.cat([y, z.to(dtype)]) for y, z in zip(ys, zs)]
            spans[rows] = slice(at, at + zs[0].shape[0])
            at += zs[0].shape[0]
        return tuple(ys), spans

    def part(outs, span):
        return tuple(o[span] for o in outs)

    n_launch = {"cdyn_period_cm": period_launches["cdyn_period_cm"],
                "cdyn_rollout_cm": launches["cdyn_rollout_cm"]}
    lib = kernels.load()
    tol64, tol32 = TOL["float64"][1], TOL["float32"][1]
    ops = None
    records = []
    for name in CM_KERNELS:
        run32, run64 = run_of(name, env), run_of(name, env64)
        plain32, plain64 = ((replayed(run32.plain), replayed(run64.plain)) if case.replay else
                            (run32.plain, run64.plain))
        xs, cut = main_inputs[name], case.cuts[name]
        ms = _time_cuda(lambda: run32.kernel(*xs), case.reps[name == "cdyn_rollout_cm"])
        ms_part = _time_cuda(lambda: run32.kernel(*xs, **cut), case.reps[2]) if cut else ms
        span = f" over {cut}" if cut else ", the whole launch"

        # float32: the main path's envs, then the perturbed ones
        xs32, spans32 = joined(name, xs, case.extra_rows[:1], torch.float32)
        outs = run32.kernel(*xs32, **cut)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs = plain32(*xs32, **cut)
        torch.cuda.synchronize()
        plain_part_ms = (time.perf_counter() - t0) * 1e3
        main = spans32["main"]
        outs32, refs32 = part(outs, main), part(refs, main)
        n_extra[name] = outs[2].shape[-1]
        io_cols = sum(x.shape[-1] for x in xs) + sum(o.shape[-1] for o in outs)
        e_abs = abs_err(outs32, refs32)
        e32_main, at32_main = output_error(outs32, refs32, "float32")
        nudged = (torch.nextafter(xs[0], torch.full_like(xs[0], math.inf)),) + xs[1:]
        e32_ulp, at32_ulp = output_error(run32.kernel(*nudged, **cut), outs32, "float32")
        log(f"{tag} {name} float32 B={B}{span}, main path states (printed, not held): "
            f"{ERR_NAME['float32']} {e32_main:.3e} at {at32_main}, max abs err {e_abs:.3e}; the "
            f"kernel against itself with q moved one ulp {e32_ulp:.3e} at {at32_ulp}")
        errs = {}
        if "mixed" in spans32:
            e32, at32 = output_error(part(outs, spans32["mixed"]), part(refs, spans32["mixed"]),
                                     "float32")
            log(f"{tag} {name} float32 B={B_CM_ROWS}, rows mixed{span}: {ERR_NAME['float32']} "
                f"{e32:.3e} at {at32} (tol {tol32:g})")
            check(e32 < tol32, f"{model} {name} float32 disagrees with its plain version: {e32}")
            errs["f32_q90_err_mixed"] = e32
        del outs, refs

        e64 = None
        if name in case.f64:  # the main path's envs one short, then the other states
            xs64, spans64 = joined(name, tuple(x[: B - 1] for x in xs), case.extra_rows,
                                   torch.float64)
            outs, refs = run64.kernel(*xs64, **cut), plain64(*xs64, **cut)
            torch.cuda.synchronize()
            main = spans64["main"]
            e64, at64 = output_error(part(outs, main), part(refs, main), "float64")
            n_std = n_extra["cdyn_period_cm"] - cset.total_rows - cset.n_contacts - cset.n_bounds
            lam_cols = slice(n_std, n_std + cset.total_rows)
            cact_cols = slice(lam_cols.stop, lam_cols.stop + cset.n_contacts)
            bact_cols = slice(cact_cols.stop, cact_cols.stop + cset.n_bounds)
            zeroed = outs[2][main].clone()
            zeroed[:, lam_cols] = 0.0
            e_zero = float(column_errors(zeroed, refs[2][main]).max())
            one_sweep = run_of(name, env64, dataclasses.replace(run64.opts, iter_max=1))
            e_sweep, at_sweep = output_error(part(one_sweep.kernel(*xs64, **cut), main),
                                             part(refs, main), "float64")
            log(f"{tag} {name} float64 B={xs64[0].shape[0]} ({B - 1} main path states first)"
                f"{span}: {ERR_NAME['float64']} {e64:.3e} at {at64} (tol {tol64:g}); witnesses: "
                f"multipliers zeroed {e_zero:.3e}, one PGS sweep {e_sweep:.3e} at {at_sweep}")
            check(all(bool(torch.isfinite(o).all()) for o in outs) and e64 < tol64,
                  f"{model} {name} float64 disagrees on the main path's states: {e64}")
            check(e_zero > tol64 and e_sweep > tol64, f"{model} {name}: the float64 check misses a "
                  "wrong solver")
            # float32's rounding: the kernel and the plain version each against float64
            truth = tuple(r.double() for r in part(refs, main))
            e_k, at_k = output_error(tuple(o[: B - 1].double() for o in outs32), truth, "float32")
            e_p, at_p = output_error(tuple(r[: B - 1].double() for r in refs32), truth, "float32")
            log(f"{tag} {name} float32 against float64 on the main path's states{span}: the "
                f"kernel {e_k:.3e} at {at_k}, the plain version {e_p:.3e} at {at_p} "
                f"({ERR_NAME['float32']}, printed)")
            errs.update(f32_q90_kernel_to_f64=e_k, f32_q90_plain_to_f64=e_p)
            for rows in case.extra_rows:
                o, r = part(outs, spans64[rows]), part(refs, spans64[rows])
                e, at = output_error(o, r, "float64")
                nonzero = int((o[2][:, lam_cols] != 0).sum(-1).max())
                active = int((4 * o[2][:, cact_cols].sum(-1) + o[2][:, bact_cols].sum(-1)).min())
                log(f"{tag} {name} float64 B={B_CM_ROWS}, rows {rows}{span}: "
                    f"{ERR_NAME['float64']} {e:.3e} at {at}; at most {nonzero} multipliers nonzero "
                    f"in an env, at least {active} rows active")
                check(e < tol64, f"{model} {name} float64 disagrees with rows {rows}: {e}")
                if rows == "none":
                    check(nonzero == 0 and active == 0,
                          f"{model} {name}: a row or a multiplier active where none should be")
                if rows == "all":
                    check(active > CM_REG_ROWS,
                          f"{model} {name}: no row past the registers' is active")
                errs[f"f64_err_{rows}"] = e
            del outs, refs
        del outs32, refs32

        if ops is None:
            ops = waited(counting, f"{model}'s op counts") if counting else cm_model_op_counts(*args)
            log(f"[{model}-cm-ops] plain-version scalar ops per env at the main path's state, zero "
                f"operands folded away: {ops}")
        packed = run32.cd.pack(run32.tau_c, run32.dt, run32.imu_frames, device, torch.float32)
        check(solver.cm_ext(packed, run32.pack(device, torch.float32)) == int(case.ext),
              f"{model}: the extended body taken where it should not be, or not taken")
        geometry = _cm_geometry_record(lib, device, run32, run64, name, False, case.ext)
        regs_terrain = _cm_registers(lib.build.ptxas_log, name, "f", True, case.ext)
        t_ops = ops[name] * B / PEAK_F32_FLOPS * 1e3
        t_bytes = io_cols * 4 * B / PEAK_BYTES * 1e3
        rec = {
            "name": name,
            "route": "cuda",
            "source": "jiminy_torch/csrc/pgs.cuh",
            "replaces": cdyn.KERNELS[name].replaces.split()[0],
            "launches": n_launch[name],
            "max_abs_err": e_abs,
            "ms": ms,
            "plain_ms": None if cut else plain_part_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
            "model": case.label,
            "batch": B,
            "plain_ms_basis": ("measured" if not cut else
                               f"not measured: the plain version's whole launch was not run; "
                               f"over {cut} it took plain_ms_part (its batch {xs32[0].shape[0]}), "
                               f"the kernel ms_part"),
            "cut_compared": cut or None,
            "ms_part": ms_part if cut else None,
            "plain_ms_part": plain_part_ms if cut else None,
            "ops_per_env": ops[name],
            "bytes_per_env": io_cols * 4,
            "f32_q90_err_main": e32_main,
            "f32_q90_one_ulp_witness": e32_ulp,
            "f64_err_ragged": e64,
            **errs,
            **geometry,
            "registers_terrain": regs_terrain,
        }
        plain_txt = (f"plain {plain_part_ms:.1f} ms (host clock, measured)" if not cut else
                     f"plain not timed over the whole launch; over {cut} the kernel {ms_part:.3f} "
                     f"ms (CUDA events), the plain version {plain_part_ms:.1f} ms (host clock, "
                     f"B={xs32[0].shape[0]})")
        log(f"[kernel] {case.label} {name} B={B} float32: {ms:.3f} ms (CUDA events), {plain_txt}, "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; {ops[name]} ops and "
            f"{rec['bytes_per_env']} B an env), {rec['bound_ms'] / ms:.2%} of it; "
            f"{_geometry_text(rec)} ({regs_terrain} registers on terrain); |kernel-plain| on the "
            f"main path's states{span} {e_abs:.3e}; launches {rec['launches']} on {smi}")
        records.append(rec)
    return records


def _cm_wide_main_path(device, smi, model):
    """The model at float32, B_CM_WIDE: launch counts to 0, the batched reset
    (the plain constrained solve, timed), a warm-up step and N_STEPS_CM_WIDE
    steps of zero actions through `make(...).step` (one cdyn_rollout_cm a
    step, nothing else), counts read; env-steps/s, the step's time against
    its one launch (CUDA events), all finite, phase 7's physics checks
    (weight, joint limits, multipliers in their boxes and cones); then one
    step of the per-period path (`Engine.step`: one cdyn_period_cm a
    controller period, nothing else)."""
    import torch

    from jiminy_torch.ops import cdyn

    env = _cm_env(device, torch.float32, model)
    eng, cset = env.engine, env.engine.cset
    base = _step_controller(env)[0]
    tag = f"[{model}-cm]"
    log(f"{tag} nq {env.robot.nq}, nv {env.robot.nv}, {env.robot.nmotors} motors, rows "
        f"{cset.total_rows} ({cset.n_bounds} bounds, {cset.n_contacts} contacts x 4), "
        f"{base.n_ctrl_per_step} ticks x {eng.n_substeps} substeps a step")
    check(cset.total_rows == {"atlas-pid": 78, "atlas-reduced-pid": 60, "ant-bounds": 44}[model],
          f"{model}: unexpected row count {cset.total_rows}")
    action = torch.zeros(env.action_size, device=device)
    cdyn.reset_launch_counts()
    t0 = time.perf_counter()
    st, _ = env.reset(batch_size=B_CM_WIDE)
    torch.cuda.synchronize()
    reset_ms = (time.perf_counter() - t0) * 1e3
    st, *_ = env.step(st, action)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_STEPS_CM_WIDE):
        st, obs, reward, term, trunc, _ = env.step(st, action)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    log(f"{tag} float32 B={B_CM_WIDE}, reset ({reset_ms:.1f} ms, host clock) + warm-up + "
        f"{N_STEPS_CM_WIDE} steps: launches {launches}")
    check(launches == {k: (N_STEPS_CM_WIDE + 1 if k == "cdyn_rollout_cm" else 0)
                       for k in launches},
          f"{model}: cdyn_rollout_cm not once a step (and nothing else)")
    sim = st.sim
    for name, x in (("q", sim.q), ("v", sim.v), ("reward", reward), ("lam", sim.lam),
                    ("contact_forces", sim.contact_forces)):
        check(bool(torch.isfinite(x).all()), f"{model}: non-finite {name} on the main path")
    steps_per_s = B_CM_WIDE * N_STEPS_CM_WIDE / elapsed
    log(f"{tag} base height mean {float(sim.q[:, 2].mean()):.4f} m, terminated share "
        f"{float(term.float().mean()):.4f}; env-steps/s {steps_per_s:.1f} ({elapsed:.4f} s for "
        f"{N_STEPS_CM_WIDE} steps, host clock) on {smi}")
    physics_checks(env, sim)

    env.use_fused_rollout = False
    cdyn.reset_launch_counts()
    t0 = time.perf_counter()
    st2, *_ = env.step(st, action)
    torch.cuda.synchronize()
    elapsed_pp = time.perf_counter() - t0
    period_launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    pp_steps_per_s = B_CM_WIDE / elapsed_pp
    log(f"{tag} per-period path (Engine.step), 1 step: launches {period_launches}; env-steps/s "
        f"{pp_steps_per_s:.1f} on {smi}")
    check(period_launches == {k: (base.n_ctrl_per_step if k == "cdyn_period_cm" else 0)
                              for k in period_launches},
          f"{model}: cdyn_period_cm not once a controller period (and nothing else)")
    check(bool(torch.isfinite(st2.sim.q).all()) and bool(torch.isfinite(st2.sim.lam).all()),
          f"{model}: non-finite state on the per-period path")
    env.use_fused_rollout = True
    return env, launches, period_launches, steps_per_s, reset_ms, st, st2


def cm_wide_main_paths(device, smi, models, counters=None):
    """Phase 25's main path for each of `models` (of CM_WIDE_MODELS), each
    model's op count started in a worker of `counters` at once (an Atlas's
    takes longer than its records on the CPU): what `cm_wide_records`
    takes, some phases later."""
    paths = []
    for model in models:
        env, launches, period_launches, sps, reset_ms, st, st2 = _cm_wide_main_path(
            device, smi, model)
        counting = (counters.submit(cm_model_op_counts, *cm_count_args(model, env, st))
                    if counters else None)
        paths.append((model, env, launches, period_launches, sps, reset_ms, st, st2, counting))
    return paths


def cm_wide_records(paths, smi):
    """`phase_cm_records` on each of `cm_wide_main_paths`'s runs."""
    records, rates = [], {}
    while paths:
        model, env, launches, period_launches, sps, reset_ms, st, st2, counting = paths.pop(0)
        records += phase_cm_records(model, env, launches, period_launches, smi, st, st2,
                                    counting=counting)
        rates[model] = (sps, reset_ms)
        del env, st, st2
        free_replays()
    return records, rates


# --------------------------------------------------------------------------- #
# The flexible ANYmal: cdyn_accel's SPHERICAL instance, stage by stage
# --------------------------------------------------------------------------- #

N_STEPS_FLEX = 3  # the flexible ANYmal's main path, after a warm-up step
N_PERIODS_FLEX_RESOLVED = 50  # periods of 1e-4 s with substeps that resolve the flexibility
FLEX_DEFLECTION_MIN = 1e-6  # [rad] the flexibility joints bend under the motors' reaction


def flex_op_counts():
    """Ops per env of one `cdyn_accel` evaluation of the flexible ANYmal
    (its plain version, `flexible_states`, B=1, on the CPU), structural
    zeros folded away and not: (ops, ops_generic)."""
    import torch

    from jiminy_torch.envs import make
    from jiminy_torch.testing import flexible_states

    env = make("anymal-pid", flexible=True, device="cpu", dtype=torch.float64)
    q, v, tau = flexible_states(env, 1, seed=9)
    cd = env.engine._cdyn
    return tuple(count_ops(lambda: cd.accel_plain(q, v, tau), fold) for fold in (True, False))


def phase_flexible(device, smi, counts=None):
    """26. The flexible ANYmal (`make("anymal-pid", flexible=True)`: the
    procedural look-alike with a spherical flexibility joint before each
    knee, nq 35, nv 30, 4 SPHERICAL joints), jiminy_tpu's per-stage path:
    every RK4 stage one `cdyn_accel` launch of its SPHERICAL instance, on
    the card a controller tick replayed from a CUDA graph.

    - Main path, float32, B=B_MAIN: launch counts to 0, the reset (one
      launch), counts read; a warm-up step (its first tick captures the
      graph), counts to 0, N_STEPS_FLEX steps of zero actions (8 ticks x (5 x
      4 + 1) = 168 launches a step, nothing else), counts read: env-steps/s,
      the step's time, cdyn_accel's share of it (CUDA events on the reset
      states x 168 over the host-clocked step). As configured (RK4 at 1 ms)
      the state turns non-finite within two ticks, in jiminy_tpu as here
      (`testing.resolving_options`): the finite share is reported, not held.
    - The same robot with `resolving_options` (substeps of 2.5e-5 s,
      periods of 1e-4 s): N_PERIODS_FLEX_RESOLVED periods through
      `Engine.step` under random motor commands from the reset: all finite,
      every env standing, the flexibility joints bent.
    - cdyn_accel against its plain version at float64, every column within
      1e-9: on the main path's reset states, on the resolved run's states,
      on `flexible_states` (random unit quaternions at the flexibility
      joints in half the envs, within 1e-4 to 1e-2 rad of the identity in
      the other half), and at B_MAIN - 1 on those; at float32 on the
      perturbed states by TOL's rule, and printed on the reset states beside
      a one-ulp witness. A zeroed output is refused.
    - Its record: ms on the resolved states (CUDA events), the plain
      version's on them (host clock), ops counted on the plain version
      (`flex_op_counts`), bytes (q, v, tau read, qdd written), registers,
      shared memory and envs an SM of the SPHERICAL instance."""
    import torch

    from jiminy_torch.envs import make
    from jiminy_torch.ops import cdyn, kernels
    from jiminy_torch.testing import flexible_states, resolving_options

    env = make("anymal-pid", flexible=True, device=device)
    eng = env.engine
    m = env.robot.model
    n_ticks = env.env.n_ctrl_per_step
    per_step = n_ticks * (4 * eng.n_substeps + 1)
    log(f"[flexible] nq {m.nq}, nv {m.nv}, {m.njoints} joints "
        f"({sum(t == 4 for t in m.joint_types)} SPHERICAL), {env.robot.nmotors} motors; "
        f"{n_ticks} ticks x ({eng.n_substeps} RK4 substeps x 4 + 1) = {per_step} cdyn_accel "
        f"launches a step")
    check(eng._stagewise and not eng.supports_fused_rollout and per_step == 168,
          "the flexible ANYmal does not take the per-stage path")
    action = torch.zeros(env.action_size, device=device)
    cdyn.reset_launch_counts()
    t0 = time.perf_counter()
    st, _ = env.reset(batch_size=B_MAIN)
    torch.cuda.synchronize()
    reset_ms = (time.perf_counter() - t0) * 1e3
    reset_launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    check(reset_launches == {k: int(k == "cdyn_accel") for k in reset_launches},
          f"flexible reset: launches {reset_launches}")
    check(bool(torch.isfinite(st.sim.a).all()), "flexible reset: non-finite accelerations")
    q0, v0 = st.sim.q.contiguous(), st.sim.v.contiguous()
    tau0 = eng._joint_torques(st.sim.command, q0, v0)[1].contiguous()
    t0 = time.perf_counter()
    st, *_ = env.step(st, action)  # warm-up (its first tick captures the graph)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    cdyn.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(N_STEPS_FLEX):
        st, *_ = env.step(st, action)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
    log(f"[flexible] float32 B={B_MAIN}: reset {reset_ms:.1f} ms (launches {reset_launches}), "
        f"warm-up step {warm_s:.2f} s (the graph's capture), {N_STEPS_FLEX} steps: launches "
        f"{launches}")
    check(launches == {k: (per_step * N_STEPS_FLEX if k == "cdyn_accel" else 0)
                       for k in launches},
          "flexible main path: cdyn_accel not 168 times a step (and nothing else)")
    step_ms = elapsed / N_STEPS_FLEX * 1e3
    steps_per_s = B_MAIN * N_STEPS_FLEX / elapsed
    finite_share = float(torch.isfinite(st.sim.q).all(-1).float().mean())
    kern32 = eng._cdyn.accel_kernel
    ms_reset = _time_cuda(lambda: kern32(q0, v0, tau0), 20)
    share = per_step * ms_reset / step_ms
    log(f"[flexible] env-steps/s {steps_per_s:.1f} ({step_ms:.1f} ms a step, host clock); "
        f"cdyn_accel {ms_reset:.4f} ms on the reset states (CUDA events) x {per_step} = "
        f"{share:.1%} of the step; share of envs still finite {finite_share:.4f} (RK4 at 1 ms "
        f"diverges on the flexibility's damped mode, as in jiminy_tpu) on {smi}")
    del st

    # The same robot with substeps that resolve the flexibility
    res = make("anymal-pid", flexible=True, device=device,
               options=resolving_options(eng.options))
    rst, _ = res.reset(batch_size=B_MAIN)
    sim = rst.sim
    cmd = _commands(B_MAIN, 12, torch.float32, device, seed=5, scale=0.5)
    t0 = time.perf_counter()
    for _ in range(N_PERIODS_FLEX_RESOLVED):
        sim = res.engine.step(sim, cmd)
    torch.cuda.synchronize()
    res_s = time.perf_counter() - t0
    check(bool(torch.isfinite(sim.q).all()) and bool(torch.isfinite(sim.a).all()),
          "flexible, resolved substeps: non-finite state")
    bend = max(float(sim.q[:, m.q_slice(j)][:, :3].abs().max())
               for j in env.robot.flexibility.joint_indices)
    log(f"[flexible] resolved substeps ({res.engine.n_substeps} of "
        f"{res.engine.tick_period / res.engine.n_substeps:.1e} s a period): "
        f"{N_PERIODS_FLEX_RESOLVED} periods in {res_s:.2f} s, base height "
        f"{float(sim.q[:, 2].min()):.4f}-{float(sim.q[:, 2].max()):.4f} m, largest flexibility "
        f"quaternion component {bend:.3e}")
    check(bend > FLEX_DEFLECTION_MIN, f"flexible: the flexibility joints do not bend ({bend})")
    check(float(sim.q[:, 2].min()) > env.env.base_height_min, "flexible: a robot fell")
    q1, v1 = sim.q.contiguous(), sim.v.contiguous()
    tau1 = res.engine._joint_torques(cmd, q1, v1)[1].contiguous()
    del res, rst, sim

    # The kernel against its plain version
    env64 = make("anymal-pid", flexible=True, device=device, dtype=torch.float64)
    cd64, cd32 = env64.engine._cdyn, eng._cdyn
    pert = flexible_states(env64, B_MAIN, seed=0)
    states = {"the main path's reset": (q0, v0, tau0), "the resolved run's": (q1, v1, tau1),
              "perturbed": pert}
    errs = {}
    for label, xs in states.items():
        xs = tuple(x.double() for x in xs)
        out, ref = cd64.accel_kernel(*xs), cd64.accel_plain(*xs)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"flexible cdyn_accel: non-finite on {label} states")
        errs[label], at = output_error((out,), (ref,), "float64")
        log(f"[check] flexible cdyn_accel float64 B={B_MAIN}, {label} states: column max rel err "
            f"{errs[label]:.3e} at {at} (tol {TOL['float64'][0]:g})")
        check(errs[label] < TOL["float64"][0], f"flexible cdyn_accel float64 disagrees on {label} "
              f"states: {errs[label]}")
        if label == "perturbed":
            e_zero, _ = output_error((torch.zeros_like(out),), (ref,), "float64")
            check(e_zero > TOL["float64"][0], "flexible cdyn_accel: the check passes a zeroed output")
            b_rag = B_MAIN - 1
            out_rag = cd64.accel_kernel(*(x[:b_rag] for x in xs))
            errs["ragged"], _ = output_error((out_rag,), (ref[:b_rag],), "float64")
            log(f"[check] flexible cdyn_accel float64 B={b_rag} (ragged), perturbed states: column "
                f"max rel err {errs['ragged']:.3e}")
            check(errs["ragged"] < TOL["float64"][0], "flexible cdyn_accel disagrees one env short")
        del out, ref
    p32 = tuple(x.float() for x in pert)
    out, ref = kern32(*p32), cd32.accel_plain(*p32)
    e32_pert, at32 = output_error((out,), (ref,), "float32")
    log(f"[check] flexible cdyn_accel float32 B={B_MAIN}, perturbed states: column q90 err / rms "
        f"{e32_pert:.3e} at {at32} (tol {TOL['float32'][0]:g})")
    check(e32_pert < TOL["float32"][0], f"flexible cdyn_accel float32 disagrees: {e32_pert}")
    out = kern32(q0, v0, tau0)
    e32_main, _ = output_error((out,), (cd32.accel_plain(q0, v0, tau0),), "float32")
    nudged = torch.nextafter(q0, torch.full_like(q0, math.inf))
    e32_ulp, _ = output_error((kern32(nudged, v0, tau0),), (out,), "float32")
    log(f"[check] flexible cdyn_accel float32, the reset states (printed, not held): column q90 "
        f"err / rms {e32_main:.3e}; the kernel against itself with q moved one ulp {e32_ulp:.3e}")
    del out, ref, pert, p32, env64

    # Its record, timed on the resolved run's states
    ms = _time_cuda(lambda: kern32(q1, v1, tau1), 20)
    plain = cd32.accel_plain
    plain(q1, v1, tau1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain(q1, v1, tau1)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    e_abs = abs_err((kern32(q1, v1, tau1),), (ref,))
    ops, ops_generic = waited(counts, "the flexible op counts") if counts is not None else flex_op_counts()
    nbytes = (m.nq + 3 * m.nv) * 4
    t_ops = ops * B_MAIN / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes * B_MAIN / PEAK_BYTES * 1e3
    lib = kernels.load()
    packed = cd32.pack(None, 0.0, (), device, torch.float32)
    c = packed.counts
    per_env = {elt: lib.accel_smem_bytes(c["nj"], c["nq"], c["nv"], c["nc"], elt, c["nsph"])[0]
               for elt in (4, 8)}
    per_sm = {elt: lib.sp_envs_per_sm("cdyn_accel", elt, per_env[elt], sph=True) for elt in (4, 8)}
    regs = _cm_registers(lib.build.ptxas_log, "cdyn_accel", "f", False, True)
    rec = {
        "name": "cdyn_accel", "route": "cuda", "source": "jiminy_torch/csrc/spring.cuh",
        "replaces": cdyn.KERNELS["cdyn_accel"].replaces.split()[0],
        "launches": 1 + per_step * N_STEPS_FLEX, "max_abs_err": e_abs, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
        "model": "anymal-pid (flexible)", "instance": "SPHERICAL (kSph)",
        "ms_main_path_reset_states": ms_reset, "env_steps_per_s": steps_per_s,
        "step_ms": step_ms, "accel_share_of_step": share, "finite_share_after_steps": finite_share,
        "ops_per_env": ops, "ops_per_env_generic": ops_generic, "bytes_per_env": nbytes,
        "f64_err_main": errs["the main path's reset"], "f64_err_resolved": errs["the resolved run's"],
        "f64_err_perturbed": errs["perturbed"], "f64_err_ragged": errs["ragged"],
        "f32_q90_err_perturbed": e32_pert, "f32_q90_err_main": e32_main,
        "f32_q90_err_main_one_ulp": e32_ulp, "registers": regs,
        "smem_per_env": per_env[4], "smem_per_env_f64": per_env[8],
        "envs_per_sm": per_sm[4], "envs_per_sm_f64": per_sm[8],
    }
    log(f"[kernel] anymal-pid (flexible) cdyn_accel B={B_MAIN} float32: {ms:.4f} ms (CUDA events, "
        f"the resolved run's states), plain {plain_ms:.1f} ms (host clock), bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; {ops} ops, {ops_generic} generic, "
        f"{nbytes} B an env), {rec['bound_ms'] / ms:.2%} of it; {regs} registers, "
        f"{per_env[4]} / {per_env[8]} B an env, {per_sm[4]} / {per_sm[8]} envs an SM (float32 / "
        f"float64); launches {rec['launches']} on {smi}")
    return [rec], steps_per_s


B_PROC_CHECK = 1024  # the procedural Atlas, Digit and ant: their kernels at float64
PROC_IDS = ("atlas-pid", "digit-pid", "ant")
# their plain versions over one substep of a period and one tick of one
# substep of a rollout (cdyn_accel whole)
PROC_CUT = {"cdyn_accel": {}, "cdyn_period": dict(n_substeps=1),
            "cdyn_rollout": dict(n_ticks=1, n_substeps=1), "cdyn_period_cm": dict(n_substeps=1),
            "cdyn_rollout_cm": dict(n_ticks=1, n_substeps=1)}
N_PERIODS_FOREST = 10  # the forest's main path: periods in each contact mode
B_FOREST_CHECK = 4096  # the forest at float64: kernels against plain, against single engines
FOREST_TOL = 1e-12  # the forest against single engines, of each column's scale
B_COUPLED = 8192  # the coupled ANYmals and the self-colliding Atlas (the generic path)
N_PERIODS_COUPLED = 2
COUPLING_TOL = 1e-9  # the couplings' net world force, of its scale


def phase_procedural_checks(device):
    """The procedural atlas-pid, digit-pid and ant (`procedural=True`) at
    float64, B=B_PROC_CHECK: a reset and one step of zero actions through
    the main path (launch counts read: the spring envs one cdyn_accel at the
    reset and one cdyn_rollout, the Digit one cdyn_rollout_cm, nothing
    else), then each kernel of the path against its plain version on the
    step's states over PROC_CUT, every column within 1e-9 (cdyn_accel on
    `perturbed_states`)."""
    import torch

    from jiminy_torch.envs import make
    from jiminy_torch.ops import cdyn
    from jiminy_torch.testing import perturbed_states

    t_phase = time.perf_counter()
    errs = {}
    for env_id in PROC_IDS:
        env = make(env_id, device=device, dtype=torch.float64, procedural=True)
        eng = env.engine
        B = B_PROC_CHECK
        cdyn.reset_launch_counts()
        st, _ = env.reset(batch_size=B)
        st, *_ = env.step(st, torch.zeros(env.action_size, device=device, dtype=torch.float64))
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in cdyn.KERNELS.items() if c.launches}
        loops = eng._cdyn_cm is not None
        want = {"cdyn_rollout_cm": 1} if loops else {"cdyn_accel": 1, "cdyn_rollout": 1}
        check(launches == want, f"procedural {env_id}: launches {launches}, expected {want}")
        sim = st.sim
        check(bool(torch.isfinite(sim.q).all() and torch.isfinite(sim.v).all()),
              f"procedural {env_id}: non-finite state after a step")
        base, key, ctrl, carry_of = _step_controller(env)
        nm = env.robot.nmotors
        if loops:
            names = ("cdyn_period_cm", "cdyn_rollout_cm")
            inputs = {
                "cdyn_period_cm": (sim.q, sim.v, torch.cat([sim.command.expand(B, nm),
                                                           _loop_row(sim, torch.float64)], -1)),
                "cdyn_rollout_cm": (sim.q, sim.v, torch.cat([sim.command.new_zeros((B, nm)),
                                                            sim.distance_ref], -1),
                                    torch.cat([carry_of(st), _cm_solver_row(sim, torch.float64)],
                                              -1)),
            }
        else:
            names = ("cdyn_accel", "cdyn_period", "cdyn_rollout")
            q, v, tau = perturbed_states(env.env if hasattr(env, "env") else env, B, seed=27,
                                         device=device, dtype=torch.float64)
            inputs = {"cdyn_accel": (q, v, tau),
                      "cdyn_period": (sim.q, sim.v, sim.command.expand(B, nm)),
                      "cdyn_rollout": (sim.q, sim.v, sim.command.new_zeros((B, env.action_size)),
                                       carry_of(st))}
        for name in names:
            if name == "cdyn_accel":
                kernel, plain = eng._cdyn.accel_kernel, eng._cdyn.accel_plain
            elif name in ("cdyn_period", "cdyn_period_cm"):
                run = eng._get_period_run("rk4")
                kernel, plain = run.kernel, run.plain
            else:
                run = eng._get_rollout_run(key, ctrl, base.n_ctrl_per_step)
                kernel, plain = run.kernel, run.plain
            xs, cut = inputs[name], PROC_CUT[name]
            outs, refs = kernel(*xs, **cut), plain(*xs, **cut)
            outs = outs if isinstance(outs, tuple) else (outs,)
            refs = refs if isinstance(refs, tuple) else (refs,)
            torch.cuda.synchronize()
            e, at = output_error(outs, refs, "float64")
            log(f"[procedural-check] {env_id} {name} float64 B={B} ({cut or 'whole'}): "
                f"{ERR_NAME['float64']} {e:.3e} at {at} (tol {TOL['float64'][1]:g}); max abs err "
                f"{abs_err(outs, refs):.3e}")
            check(all(bool(torch.isfinite(o).all()) for o in outs),
                  f"procedural {env_id} {name}: non-finite")
            check(e < TOL["float64"][1], f"procedural {env_id} {name} disagrees with its plain "
                  f"version: {e}")
            errs[(env_id, name)] = e
    log(f"[procedural-check] launches of the steps read; phase {time.perf_counter() - t_phase:.1f} s")
    return errs


def forest_op_counts(mode):
    """Scalar ops per env of one period of the ANYmal + acrobot forest in
    `mode` ("spring" or "constraint"), counted on the plain version at B=1
    on the CPU at a reset state, zero operands folded away."""
    import torch

    from jiminy_torch.engine.multi import MultiRobotEngine
    from jiminy_torch.envs import make
    from jiminy_torch.testing import constraint_mode_options, forest_robots, forest_states

    base = make("anymal-pid", device="cpu", dtype=torch.float64)
    opts = base.engine.options if mode == "spring" else constraint_mode_options(base.engine.options)
    multi = MultiRobotEngine(forest_robots(), opts, device="cpu", dtype=torch.float64)
    q0, v0 = forest_states(multi, base.env.nominal_q, 1, seed=28)
    sim = multi.merge_states(multi.reset(q0, v0))
    xs = _forest_inputs(multi, sim, torch.float64)
    run = multi.engine._get_period_run("rk4")
    if mode == "spring":
        return count_elem_ops(lambda: run.plain(*xs), fold_zeros=True)
    qc, vc, ccl = ([x[..., i] for i in range(x.shape[-1])] for x in xs)
    sub = count_elem_ops(lambda: run.substep(qc, vc, ccl), True)
    fin = count_elem_ops(lambda: run.final_outputs(qc, vc, ccl), True)
    return run.n_substeps * sub + fin


def _forest_inputs(multi, sim, dtype):
    """(q, v, command row) of one period of the merged engine at `sim`: on
    the constrained core the loops' lengths, the solver carry and the
    rolling heights ride the command row (`Engine._integrate_period`)."""
    import torch

    eng = multi.engine
    B = sim.q.shape[0]
    cmd = sim.command.expand(B, eng.robot.nmotors).to(dtype)
    if eng._cdyn_cm is None:
        return sim.q.to(dtype), sim.v.to(dtype), cmd
    return sim.q.to(dtype), sim.v.to(dtype), torch.cat(
        [cmd, sim.distance_ref.to(dtype), _cm_solver_row(sim, dtype), sim.rolling_ref.to(dtype)], -1)


def phase_forest_checks(device):
    """Phase 28's float64 checks, in each contact mode, at B=B_FOREST_CHECK
    (`testing.forest_states`, seed 28): the forest N_PERIODS_FOREST periods
    of zero commands through `MultiRobotEngine.step` against the ANYmal and
    the acrobot each stepped by an engine of its own (its own kernel; the
    acrobot in constraint mode has no row: the generic path) within
    FOREST_TOL of each column's scale; then the forest's kernel against its
    plain version over one substep (eager) on the states the forest reached,
    within 1e-9. Returns mode -> the numbers phase 28's records carry."""
    import torch

    from jiminy_torch.engine.engine import Engine
    from jiminy_torch.engine.multi import MultiRobotEngine
    from jiminy_torch.envs import make
    from jiminy_torch.ops import cdyn
    from jiminy_torch.testing import (column_errors, constraint_mode_options, forest_robots,
                                      forest_states)

    base = make("anymal-pid", device=device, dtype=torch.float64)
    out = {}
    for mode in ("spring", "constraint"):
        opts = (base.engine.options if mode == "spring"
                else constraint_mode_options(base.engine.options))
        name = "cdyn_period" if mode == "spring" else "cdyn_period_cm"
        Bc = B_FOREST_CHECK
        multi = MultiRobotEngine(forest_robots(), opts, device=device, dtype=torch.float64)
        q0, v0 = forest_states(multi, base.env.nominal_q, Bc, seed=28, device=device,
                               dtype=torch.float64)
        cmd = {n: torch.zeros((Bc, r.nmotors), dtype=torch.float64, device=device)
               for n, r in multi.robots.items()}
        cdyn.reset_launch_counts()
        forest = multi.reset(q0, v0)
        for _ in range(N_PERIODS_FOREST):
            forest = multi.step(forest, cmd)
        forest_launches = cdyn.KERNELS[name].launches
        check(forest_launches == N_PERIODS_FOREST,
              f"the float64 forest in {mode} mode did not run {name} once a period")
        single_launches, worst = {}, 0.0
        for rname, robot in multi.robots.items():
            single = Engine(robot, opts, device=device, dtype=torch.float64)
            cdyn.reset_launch_counts()
            st = single.reset(q0[rname], v0[rname])
            for _ in range(N_PERIODS_FOREST):
                st = single.step(st, cmd[rname])
            single_launches[rname] = {k: c.launches for k, c in cdyn.KERNELS.items() if c.launches}
            for f in ("q", "v", "a"):
                e = float(column_errors(getattr(forest[rname], f), getattr(st, f)).max())
                worst = max(worst, e)
                check(e <= FOREST_TOL, f"the forest's {rname} {f} is {e} off its single engine")
        run = multi.engine._get_period_run("rk4")
        xs = _forest_inputs(multi, multi.merge_states(forest), torch.float64)
        cut = dict(n_substeps=1)  # the plain version eager: one substep of five
        outs, refs = run.kernel(*xs, **cut), run.plain(*xs, **cut)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(o).all()) for o in outs),
              f"the forest's {name}: non-finite float64 output")
        e64, at64 = output_error(outs, refs, "float64")
        check(e64 < TOL["float64"][1], f"the forest's {name} disagrees at float64: {e64}")
        out[mode] = {"e64": e64, "at64": at64, "cut": cut, "worst": worst,
                     "forest_launches": forest_launches, "single_launches": single_launches}
        del multi, forest, outs, refs
    return out


def phase_forest(device, smi, checks, counts=None):
    """The multi-robot engine's forest: the ANYmal (FREE root, joint 0) and
    the acrobot merged (`MultiRobotEngine`, no coupling: the component
    core), two joints at depth 0. In each contact mode (anymal-pid's options:
    spring-damper, cdyn_period; `constraint_mode_options`, cdyn_period_cm) at
    float32, B=B_MAIN (`testing.forest_states`, seed 28): reset, launch
    counts to 0, N_PERIODS_FOREST periods of zero commands through
    `MultiRobotEngine.step`, counts read (the period kernel once a period,
    nothing else), finite. The kernel timed (CUDA events) on the run's
    states beside its plain version (host clock; the constrained one over
    one substep, `plain_ms` null). `checks` are `phase_forest_checks`'s
    float64 numbers. Records with `"model": "forest ..."`."""
    import torch

    from jiminy_torch.engine.multi import MultiRobotEngine
    from jiminy_torch.engine import solver
    from jiminy_torch.envs import make
    from jiminy_torch.ops import cdyn, kernels
    from jiminy_torch.testing import constraint_mode_options, forest_robots, forest_states

    base_env = make("anymal-pid", device=device, dtype=torch.float32)
    nominal = base_env.env.nominal_q
    lib = kernels.load()
    records, rates = [], {}
    for mode in ("spring", "constraint"):
        t_mode = time.perf_counter()
        opts = (base_env.engine.options if mode == "spring"
                else constraint_mode_options(base_env.engine.options))
        name = "cdyn_period" if mode == "spring" else "cdyn_period_cm"
        tag = f"[forest-{mode}]"
        multi = MultiRobotEngine(forest_robots(), opts, device=device, dtype=torch.float32)
        eng = multi.engine
        check((eng._cdyn if mode == "spring" else eng._cdyn_cm) is not None,
              f"the forest did not take the component core in {mode} mode")
        B = B_MAIN
        q0, v0 = forest_states(multi, nominal, B, seed=28, device=device, dtype=torch.float32)
        t0 = time.perf_counter()
        states = multi.reset(q0, v0)
        torch.cuda.synchronize()
        reset_ms = (time.perf_counter() - t0) * 1e3
        cmd = {n: torch.zeros((B, r.nmotors), device=device) for n, r in multi.robots.items()}
        states = multi.step(states, cmd)  # warm-up
        torch.cuda.synchronize()
        cdyn.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(N_PERIODS_FOREST):
            states = multi.step(states, cmd)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {k: c.launches for k, c in cdyn.KERNELS.items()}
        check(launches[name] == N_PERIODS_FOREST and sum(launches.values()) == N_PERIODS_FOREST,
              f"the forest in {mode} mode did not run {name} once a period: {launches}")
        for rname, st in states.items():
            check(bool(torch.isfinite(st.q).all() and torch.isfinite(st.v).all()),
                  f"the forest's {rname}: non-finite state")
        rates[mode] = B * N_PERIODS_FOREST / elapsed
        log(f"{tag} ANYmal + acrobot forest float32 B={B}: reset {reset_ms:.1f} ms, "
            f"{N_PERIODS_FOREST} periods {elapsed / N_PERIODS_FOREST * 1e3:.3f} ms a period "
            f"(host clock, {rates[mode]:.1f} env-periods/s), launches {launches} on {smi}")

        # the kernel alone on the run's states, beside its plain version
        sim = multi.merge_states(states)
        run = eng._get_period_run("rk4")
        xs = _forest_inputs(multi, sim, torch.float32)
        cut = {} if mode == "spring" else dict(n_substeps=1)
        ms = _time_cuda(lambda: run.kernel(*xs), 5)
        ms_part = _time_cuda(lambda: run.kernel(*xs, **cut), 5) if cut else ms
        outs = run.kernel(*xs, **cut)
        plain = replayed(run.plain)
        if not cut:
            plain(*xs)  # the capture; the timed call below replays
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs = plain(*xs, **cut)
        torch.cuda.synchronize()
        plain_part_ms = (time.perf_counter() - t0) * 1e3
        e_abs = abs_err(outs, refs)
        e32, at32 = output_error(outs, refs, "float32")
        io_cols = sum(x.shape[-1] for x in xs) + sum(o.shape[-1] for o in outs)
        del outs, refs

        chk = checks[mode]
        log(f"{tag} float64 B={B_FOREST_CHECK} (held beside phase 16): {name} against its plain "
            f"version ({chk['cut']}) {ERR_NAME['float64']} {chk['e64']:.3e} at {chk['at64']}; the "
            f"forest over {N_PERIODS_FOREST} periods ({chk['forest_launches']} {name} launches) "
            f"against single engines (launches {chk['single_launches']}): q, v, a within "
            f"{chk['worst']:.3e} of each column's scale (tol {FOREST_TOL:g})")

        ops = waited(counts[mode], f"the {mode} forest's op counts") if counts else forest_op_counts(mode)
        t_ops = ops * B / PEAK_F32_FLOPS * 1e3
        t_bytes = io_cols * 4 * B / PEAK_BYTES * 1e3
        rec = {
            "name": name,
            "route": "cuda",
            "source": "jiminy_torch/csrc/" + ("spring.cuh" if mode == "spring" else "pgs.cuh"),
            "replaces": cdyn.KERNELS[name].replaces.split()[0],
            "launches": launches[name],
            "max_abs_err": e_abs,
            "ms": ms,
            "plain_ms": None if cut else plain_part_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
            "model": f"forest: anymal-pid + acrobot ({'spring-damper' if mode == 'spring' else 'constraint'} mode)",
            "batch": B,
            "cut_compared": cut or None,
            "ms_part": ms_part if cut else None,
            "plain_ms_part": plain_part_ms if cut else None,
            "ops_per_env": ops,
            "bytes_per_env": io_cols * 4,
            "f32_q90_err_main": e32,
            "f64_err": chk["e64"],
            "f64_cut": chk["cut"],
            "forest_vs_singles_f64": chk["worst"],
        }
        if mode == "constraint":
            packed = run.cd.pack(run.tau_c, run.dt, run.imu_frames, device, torch.float32)
            ext = bool(solver.cm_ext(packed, run.pack(device, torch.float32)))
            rec.update(_cm_geometry_record(lib, device, run, run, name, False, ext))
        plain_txt = (f"plain {plain_part_ms:.1f} ms (host clock, replayed)" if not cut else
                     f"over {cut} the kernel {ms_part:.3f} ms and the plain version "
                     f"{plain_part_ms:.1f} ms (host clock, eager)")
        log(f"[kernel] {rec['model']} {name} B={B} float32: {ms:.4f} ms (CUDA events), "
            f"{plain_txt}, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; {ops} ops and "
            f"{rec['bytes_per_env']} B an env), {rec['bound_ms'] / ms:.2%} of it; |kernel-plain| "
            f"{e_abs:.3e} ({ERR_NAME['float32']} {e32:.3e} at {at32}, printed); launches "
            f"{rec['launches']} on {smi}")
        records.append(rec)
        del multi, states, sim
        log(f"{tag} {time.perf_counter() - t_mode:.1f} s")
    return records, rates


def _net_world_wrench(model, kin, fext):
    """(net force, net torque about the world origin) of LOCAL joint
    wrenches (..., nj, 6), world axes."""
    import torch

    from jiminy_torch.ops import lie

    f_w = lie.mv(kin.rot, fext[..., 3:6])
    n_w = lie.mv(kin.rot, fext[..., 0:3]) + lie.cross(kin.pos, f_w)
    return f_w.sum(-2), n_w.sum(-2)


def phase_coupled(device, smi):
    """Couplings and collision pairs on the generic path. (a) Two ANYmals
    (`MultiRobotEngine`, anymal-pid's options) with a viscoelastic coupling
    between their bases (rest length 0.5 m) and a robot-robot collision pair
    between a's right front foot and b's left front foot (spheres of 5 cm,
    overlapping by 5 mm at the reset), float32, B=B_COUPLED: reset, launch counts to
    0, N_PERIODS_COUPLED periods (eager: a registered force turns the
    tick's CUDA graph off), counts read (no kernel), finite; at float64 on
    the reset's and the end's states each coupling's net world force (action and reaction)
    within COUPLING_TOL of its scale, and the collision pair's net torque
    too (both forces at one point). (b) The Atlas (atlas-reduced-pid's robot
    and options: the legs, whose tick's eager capture costs less than the
    whole humanoid's) with a collision pair between its feet (`testing.with_link_pairs`:
    box-box SAT), float32, B=B_COUPLED, the generic path: 2 ticks (the first
    captures the tick's CUDA graph, the second replays it), ms a tick, no
    kernel, finite, the pair's depth positive (the feet apart). It runs in
    a card-lane process beside phase 16 (`phase_lane_checks`), so its
    host-clocked times are taken there."""
    import numpy as np
    import torch

    from jiminy_torch.engine.engine import Engine
    from jiminy_torch.engine.multi import MultiRobotEngine
    from jiminy_torch.envs import assets, make
    from jiminy_torch.ops import cdyn
    from jiminy_torch.ops.kinematics import forward_kinematics
    from jiminy_torch.testing import with_link_pairs

    out = {}
    base = make("anymal-pid", device=device, dtype=torch.float32)
    nominal = base.env.nominal_q.double().cpu().numpy()
    rng = np.random.default_rng(29)
    B = B_COUPLED
    q_a = np.tile(nominal, (B, 1))
    q_a[:, 7:] += rng.normal(size=(B, nominal.size - 7)) * 0.02
    # b beside a, its left front foot 9.5 cm to the right of a's right front
    # foot: the feet's spheres (5 cm) overlap by 5 mm at the reset
    anymal = base.robot.model
    kin0 = forward_kinematics(anymal, torch.as_tensor(nominal))
    from jiminy_torch.ops.kinematics import frame_placement

    y_rf = float(frame_placement(anymal, kin0, anymal.frame_index("RF_FOOT"))[1][1])
    y_lf = float(frame_placement(anymal, kin0, anymal.frame_index("LF_FOOT"))[1][1])
    q_b = q_a.copy()
    q_b[:, 1] += y_rf - y_lf - 0.095
    feet = ({"frame_name": "RF_FOOT", "geometry": "sphere", "radius": 0.05},
            {"frame_name": "LF_FOOT", "geometry": "sphere", "radius": 0.05})

    def coupled(dtype):
        robots = {"a": assets.load_robot("anymal"), "b": assets.load_robot("anymal")}
        multi = MultiRobotEngine(robots, base.engine.options, device=device, dtype=dtype)
        multi.register_viscoelastic_coupling_force("a", "base", "b", "base", 200.0, 5.0,
                                                   rest_length=0.5)
        multi.register_collision_pair("a", feet[0], "b", feet[1])
        return multi

    multi = coupled(torch.float32)
    check(not multi.engine._use_core(), "the coupled ANYmals took the component core")
    q0 = {"a": torch.as_tensor(q_a, dtype=torch.float32, device=device),
          "b": torch.as_tensor(q_b, dtype=torch.float32, device=device)}
    cdyn.reset_launch_counts()
    states0 = states = multi.reset(q0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_PERIODS_COUPLED):
        states = multi.step(states)
    torch.cuda.synchronize()
    period_ms = (time.perf_counter() - t0) * 1e3 / N_PERIODS_COUPLED
    launches = sum(c.launches for c in cdyn.KERNELS.values())
    check(launches == 0, f"the coupled ANYmals launched kernels: {launches}")
    for rname, st in states.items():
        check(bool(torch.isfinite(st.q).all() and torch.isfinite(st.v).all()),
              f"the coupled ANYmals: {rname} non-finite")
    multi64 = coupled(torch.float64)
    model = multi64.merged_robot.model
    worst = {}
    for when, sts in (("reset", states0), ("end", states)):
        sim = multi64.merge_states({n: st.replace(q=st.q.double(), v=st.v.double())
                                    for n, st in sts.items()})
        kin = forward_kinematics(model, sim.q, sim.v)
        for (_, _, force_fn), label in zip(multi64.engine._registered_forces,
                                           ("viscoelastic", "collision")):
            fext = force_fn(sim.q.new_zeros(B), sim.q, sim.v, kin)
            f_net, n_net = _net_world_wrench(model, kin, fext)
            scale = float(fext.abs().max())
            e = worst[f"{label} at the {when}"] = (float(f_net.abs().max()),
                                                    float(n_net.abs().max()), scale)
            check(e[0] <= COUPLING_TOL * max(scale, 1.0),
                  f"the {label} coupling's net force is not zero at the {when}: {e}")
            if label == "collision":  # both forces at one point: no net torque either
                check(e[1] <= COUPLING_TOL * max(scale, 1.0),
                      f"the collision pair's net torque is not zero at the {when}: {e}")
    check(worst["collision at the reset"][2] > 1.0, "the feet's collision pair pushes nothing")
    log(f"[coupled] two ANYmals, a viscoelastic coupling and a foot-foot collision pair, float32 "
        f"B={B}: {period_ms:.1f} ms a period (eager, host clock, in a process beside phase 16; "
        f"{N_PERIODS_COUPLED} periods), no "
        f"kernel; float64 net world force / torque about the origin / largest joint wrench: "
        + ", ".join(f"{k} {f:.3e} / {n:.3e} / {s:.3e}" for k, (f, n, s) in worst.items())
        + f" on {smi}")
    out["coupled_period_ms"] = period_ms
    del multi, multi64, states, states0, sim

    atlas = make("atlas-reduced-pid", device=device, dtype=torch.float32)
    robot = with_link_pairs(atlas.robot, assets.urdf_path("atlas"), [("l_foot", "r_foot")])
    eng = Engine(robot, atlas.engine.options, device=device, dtype=torch.float32)
    check(eng._cdyn is None and not eng._use_core(), "the Atlas with pairs took the core")
    q = atlas.env.nominal_q.expand(B, -1)
    cdyn.reset_launch_counts()
    st = eng.reset(q)
    tick_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = eng.step(st)
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    launches = sum(c.launches for c in cdyn.KERNELS.values())
    check(launches == 0, f"the Atlas with pairs launched kernels: {launches}")
    check(bool(torch.isfinite(st.q).all() and torch.isfinite(st.v).all()),
          "the Atlas with pairs: non-finite state")
    _, aux = eng.dynamics_full(st.t, st.q, st.v, st.command, eng._carry_of(st))
    depth = aux["pair_depth"]
    check(bool(torch.isfinite(depth).all() and (depth > 0).all()),
          "the Atlas's feet pair: depth not finite or not positive standing")
    log(f"[coupled] atlas-reduced-pid with a box-box collision pair between its feet ({len(robot.collision_pairs_geom)} "
        f"geometry pairs), float32 B={B}, the generic path: the first tick {tick_ms[0]:.1f} ms "
        f"(eager, the CUDA graph captured), the second {tick_ms[1]:.1f} ms (replayed), host "
        f"clock, in a process beside phase 16; no kernel; pair depth {float(depth.min()):.4f} .. {float(depth.max()):.4f} m on "
        f"{smi}")
    out["atlas_pairs_tick_ms"] = tick_ms
    return out


def main():
    import concurrent.futures
    import multiprocessing

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

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        peak = torch.cuda.max_memory_reserved() / 1e9
        free_replays()
        torch.cuda.reset_peak_memory_stats()
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s (card memory reserved at most "
            f"{peak:.1f} GB; host {_host_memory()})")
        return out

    # Worker processes count ops, and run phase 17's CPU side, on the CPU
    # beside the card's phases
    counters = concurrent.futures.ProcessPoolExecutor(
        max_workers=3, mp_context=multiprocessing.get_context("spawn"),
        initializer=counting_worker)
    # Two more processes on the card run phase 16 (the cartpole's training)
    # and the Cassie golden, which launch no kernel and time nothing the
    # kernels line reads, beside the build and the phases that time nothing;
    # once the Cassie golden is done, its process takes the checks of
    # `phase_lane_checks`
    card_lane = concurrent.futures.ProcessPoolExecutor(
        max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    try:
        return run_phases(device, smi, kind, t_start, timed, counters, card_lane)
    finally:
        card_lane.shutdown(wait=True, cancel_futures=True)
        counters.shutdown(wait=True, cancel_futures=True)


def phase_lane_checks(device, smi):
    """Checks that time nothing the kernels line reads, run in a card-lane
    process once the build is done (beside phase 16 and the main process's
    checks): phase 20's loop checks (the procedural Cassie's with them),
    phase 27's procedural look-alikes, phase 28's float64 forest and phase
    29 (its host-clocked times taken beside phase 16). Returns
    `phase_forest_checks`'s numbers and `phase_coupled`'s."""
    import torch

    from jiminy_torch.ops import kernels

    kernels.load()

    def timed_here(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        free_replays()
        log(f"[phase] {name} (card lane): {time.perf_counter() - t0:.1f} s")
        return out

    timed_here("loop kernels vs plain", phase_loop_checks, device,
               {dt: _digit_make(device, dt) for dt in (torch.float64, torch.float32)},
               {torch.float64: _cm_env(device, torch.float64, "cassie-procedural")})
    timed_here("procedural look-alikes vs plain", phase_procedural_checks, device)
    forest = timed_here("forest float64 checks", phase_forest_checks, device)
    return forest, timed_here("couplings and pairs", phase_coupled, device, smi)


def run_phases(device, smi, kind, t_start, timed, counters, card_lane):
    import concurrent.futures

    import torch

    from jiminy_torch.ops import kernels

    counts = {m: counters.submit(spring_op_counts, m) for m in ("anymal-pid", "atlas-pid", "ant")}
    counts["terrain"] = counters.submit(rough_terrain_ops)
    counts["dopri"] = counters.submit(dopri_glue_calls)
    counts["flexible"] = counters.submit(flex_op_counts)
    counts["forest"] = {m: counters.submit(forest_op_counts, m) for m in ("spring", "constraint")}
    counts["ball"] = {k: counters.submit(_ball_ops, k) for k in ("sphere", "wheel")}
    ppo_cpu = {env_id: counters.submit(ppo_cpu_step, env_id, horizon, sizes)
               for env_id, horizon, sizes, _ in PPO_CASES}
    cartpole = card_lane.submit(phase_ppo_cartpole, device, smi)
    cassie_rows = card_lane.submit(cassie_golden, device)
    # Beside them: nvcc builds the kernels (its parts at once), then the
    # phases that only hold kernels against plain versions or goldens run;
    # every timed phase follows, alone on the card
    timed("build", phase_build)
    lane_checks = card_lane.submit(phase_lane_checks, device, smi)
    timed("kernels vs plain", phase_kernels_vs_plain, device)
    timed("atlas golden", phase_atlas_golden, device)
    timed("toy golden", phase_toy_golden, device)
    rough_checks = timed("terrain checks", phase_terrain_checks, device)
    timed("ant on rough ground", phase_ant_rough_check, device)
    timed("generic path against the kernels", _generic_anymal_check, device)
    ball_checks = timed("ball float64 checks", phase_ball_checks, device)
    timed("PPO cartpole learns (its process's rest)", cartpole.result)
    forest_checks, coupled = timed("card lane's checks (their process's rest)",
                                   lane_checks.result)
    env, fused_launches, period_launches, steps_per_s, st, st2 = timed(
        "main path", phase_main_path, device, smi)
    dopri = timed("DOPRI", phase_dopri, device, smi, counts["dopri"])
    launches = {"cdyn_accel": dopri["launches"], "cdyn_period": period_launches["cdyn_period"],
                "cdyn_rollout": fused_launches["cdyn_rollout"]}
    records = timed("anymal-pid kernel records", phase_kernel_records, "anymal-pid", env,
                    launches, smi, st, st2, dopri=dopri, counts=counts["anymal-pid"])
    del env, st, st2
    cm = timed("constrained main path", phase_constrained_main_path, device, smi)
    cm_env, cm_launches, cm_period_launches, cm_steps_per_s, _, cm_reset_ms, cm_st, cm_st2 = cm
    records += timed("constrained kernel records", phase_constrained_records, cm_env,
                     cm_launches, cm_period_launches, smi, cm_st, cm_st2, counters)
    del cm_env, cm_st, cm_st2
    rough, rough_sps, rough_cm_sps = timed("terrain", phase_terrain, device, smi, records,
                                           rough_checks, counts["terrain"])
    records += rough
    atlas = timed("atlas main path", phase_atlas_main_path, device, smi)
    at_env, at_launches, at_period_launches, at_steps_per_s, at_st, at_st2 = atlas
    launches = {"cdyn_accel": at_launches["cdyn_accel"],
                "cdyn_period": at_period_launches["cdyn_period"],
                "cdyn_rollout": at_launches["cdyn_rollout"]}
    records += timed("atlas-pid kernel records", phase_kernel_records, "atlas-pid", at_env,
                     launches, smi, at_st, at_st2, check_ticks=ATLAS_CHECK_TICKS,
                     check_substeps=ATLAS_CHECK_SUBSTEPS,
                     counts=counts["atlas-pid"])
    del at_env, at_st, at_st2
    # their op counts take minutes on the CPU: their records come later
    atlas_paths = timed("atlas in constraint mode: main paths", cm_wide_main_paths, device, smi,
                        ("atlas-pid", "atlas-reduced-pid"), counters)
    toys = timed("toy main path", phase_toy_main_path, device, smi)
    records += timed("pendulum kernel records", phase_pendulum_records, toys, smi)
    toy_rates = ", ".join(f"{k} {toys[k]['steps_per_s']:.1f}" for k in TOYS)
    del toys
    # The loop robots' and the 44-row ant's main paths first, their records
    # after the ant's phases: their op counts (some 20-40 s on the CPU) run
    # in workers meanwhile
    digit = timed("digit main path", phase_digit_main_path, device, smi)
    dg_env, dg_launches, dg_period_launches, dg_steps_per_s, dg_reset_ms, dg_st, dg_st2 = digit
    dg_count = counters.submit(cm_model_op_counts, *cm_count_args("digit-pid", dg_env, dg_st))
    proc = timed("procedural cassie main path", phase_digit_main_path, device, smi,
                 "cassie-procedural")
    pc_env, pc_launches, pc_period_launches, pc_steps_per_s, pc_reset_ms, pc_st, pc_st2 = proc
    pc_count = counters.submit(cm_model_op_counts,
                               *cm_count_args("cassie-procedural", pc_env, pc_st))
    ab_paths = timed("ant with its bounds as rows: main path", cm_wide_main_paths, device, smi,
                     ("ant-bounds",), counters)
    del digit, proc
    ant = timed("ant main path", phase_ant_main_path, device, smi, False)
    an_env, an_launches, an_period_launches, an_sps, _, _, an_st, an_st2 = ant
    launches = {"cdyn_accel": an_launches["cdyn_accel"],
                "cdyn_period": an_period_launches["cdyn_period"],
                "cdyn_rollout": an_launches["cdyn_rollout"]}
    records += timed("ant kernel records", phase_kernel_records, "ant", an_env, launches, smi,
                     an_st, an_st2, check_ticks=ANT_CHECK_TICKS, counts=counts["ant"])
    del ant, an_env, an_st, an_st2
    ant_cm = timed("ant constraint-mode main path", phase_ant_main_path, device, smi, True)
    ac_env, ac_launches, ac_period_launches, ac_sps, _, ac_reset_ms, ac_st, ac_st2 = ant_cm
    records += timed("ant constraint-mode kernel records", phase_cm_records, "ant", ac_env,
                     ac_launches, ac_period_launches, smi, ac_st, ac_st2, counters)
    del ant_cm, ac_env, ac_st, ac_st2
    dg_env64 = _digit_make(device, torch.float64)
    records += timed("digit-pid kernel records", phase_cm_records, "digit-pid", dg_env,
                     dg_launches, dg_period_launches, smi, dg_st, dg_st2, env64=dg_env64,
                     counting=dg_count)
    del dg_st, dg_st2, dg_env, dg_env64
    records += timed("procedural cassie kernel records", phase_cm_records, "cassie-procedural",
                     pc_env, pc_launches, pc_period_launches, smi, pc_st, pc_st2,
                     counting=pc_count)
    del pc_env, pc_st, pc_st2
    atlas_cm, wide_rates = timed("atlas in constraint mode: kernel records", cm_wide_records,
                                 atlas_paths, smi)
    records += atlas_cm
    ant_bounds, ant_bounds_rates = timed("ant with its bounds as rows: kernel records",
                                         cm_wide_records, ab_paths, smi)
    records += ant_bounds
    wide_rates.update(ant_bounds_rates)
    ball_records, ball_rates = timed("rolling ball", phase_ball, device, smi, ball_checks,
                                     counts["ball"])
    records += ball_records
    flex_records, flex_sps = timed("flexible ANYmal", phase_flexible, device, smi,
                                   counts["flexible"])
    records += flex_records
    forest_records, forest_rates = timed("forest", phase_forest, device, smi, forest_checks,
                                         counts["forest"])
    records += forest_records
    cassie_sps = timed("cassie", phase_cassie, device, smi, cassie_rows)
    t_ppo = time.perf_counter()
    ppo_anymal = timed("PPO anymal-pid", phase_ppo_anymal, device, smi)
    timed("PPO card against CPU", phase_ppo_card_vs_cpu, device, smi, ppo_cpu)
    log(f"[ppo] phases 15 and 17 {time.perf_counter() - t_ppo:.1f} s")
    log(f"[done] {time.perf_counter() - t_start:.1f} s; anymal-pid env-steps/s {steps_per_s:.1f}, "
        f"DOPRI {dopri['steps_per_s']:.1f}, constraint mode {cm_steps_per_s:.1f} (reset "
        f"{cm_reset_ms:.1f} ms), on rough ground {rough_sps:.1f} and {rough_cm_sps:.1f}, "
        f"atlas-pid {at_steps_per_s:.1f}, digit-pid {dg_steps_per_s:.1f} (reset {dg_reset_ms:.1f} "
        f"ms), ant {an_sps:.1f}, ant constraint mode {ac_sps:.1f} (reset {ac_reset_ms:.1f} ms), "
        + "".join(f"{m} constraint mode at B={B_CM_WIDE} {r[0]:.1f} (reset {r[1]:.1f} ms), "
                  for m, r in wide_rates.items()) +
        f"rolling ball sphere {ball_rates['sphere']:.1f} and wheel {ball_rates['wheel']:.1f}, "
        f"flexible anymal-pid {flex_sps:.1f} (per-stage path), procedural cassie-pid "
        f"{pc_steps_per_s:.1f} (reset {pc_reset_ms:.1f} ms), the ANYmal + acrobot forest "
        f"{forest_rates['spring']:.1f} and {forest_rates['constraint']:.1f} env-periods/s, two "
        f"coupled ANYmals {coupled['coupled_period_ms']:.1f} ms a period (eager) and the Atlas "
        f"with foot pairs {coupled['atlas_pairs_tick_ms'][1]:.1f} ms a tick (replayed), "
        f"cassie-pid {cassie_sps:.1f} (generic path), toys {toy_rates}, PPO training "
        f"(anymal-pid, 4096 envs) {ppo_anymal['steps_per_s']:.1f} on {smi}")
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
