"""Inputs for holding the kernels against their plain versions.

`perturbed_states` draws (q, v, tau) around an env's nominal pose from a numpy
seed: the base lowered so that some feet penetrate the ground, random joint
offsets with some joints pushed past their bounds, a tilted base, random
velocities and torques; `flexible_states` the same for a robot with
flexibility joints, their quaternions random or near the identity.
`constrained_inputs` draws the same kind of states
for the constrained (PGS) path, with every foot 0-3 cm into the ground and
the solver channels (warm-start multipliers, active sets) that ride the
command row and the carry, or with every row, no row or the contact rows of
a robot at rest active; `bound_row_inputs` draws them for a fixed-root
model with joint-bound rows only (the pendulum). `column_errors` and
`column_quantile_errors`
hold a kernel's outputs against its plain version column by column. The
card tests and `chip_smoke.py` use them. `constraint_mode_options` turns an
env's engine options into constraint contact mode, as `bench.py` does with
`BENCH_CONTACT=constraint`; `dopri_options` turns them to adaptive DOPRI
5(4), every other option kept; `resolving_options` cuts the substep to one
that resolves the flexibility joints' damped mode. `rough_ground` is the terrain cell's ground
(`ground_options` sets a ground); `spread_on_ground` and `place_on_ground`
put states on it at distinct (x, y). `fourbar_robot` builds jiminy_tpu's two
Cassie-shaped test models (a four-bar linkage closed by a distance loop,
with a spring-damper foot and a bounded joint in the second);
`loop_inputs` draws states and command rows for a robot with loop closures
beside its spring-damper contacts (Digit, the four-bars).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def perturbed_states(env, batch: int, seed: int, device=None, dtype=None):
    device = env.device if device is None else device
    dtype = env.dtype if dtype is None else dtype
    model = env.robot.model
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(env.nominal_q.cpu(), np.float64), (batch, 1))
    q[:, 2] += rng.uniform(-0.03, 0.01, size=batch)
    q[:, 7:] += rng.normal(size=(batch, model.nq - 7)) * 0.2
    # Push one joint per env past its upper bound for a quarter of the envs
    n_past = batch // 4
    joints = rng.integers(7, model.nq, size=n_past)
    hi = model.position_limit_upper[joints]
    q[np.arange(n_past), joints] = np.where(np.isfinite(hi), hi + 0.1, q[np.arange(n_past), joints])
    # Small random base rotation
    w = rng.normal(size=(batch, 3)) * 0.1
    th = np.linalg.norm(w, axis=1, keepdims=True)
    quat = np.concatenate([w / th * np.sin(th / 2), np.cos(th / 2)], axis=1)
    q[:, 3:7] = quat
    v = rng.normal(size=(batch, model.nv)) * 0.5
    tau = rng.normal(size=(batch, model.nv)) * 5.0

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return t(q), t(v), t(tau)


def flexible_states(env, batch: int, seed: int, device=None, dtype=None):
    """`perturbed_states` of a robot with flexibility joints, each joint's
    quaternion unit: random in the first half of the envs, within 1e-4 to
    1e-2 rad of the identity in the second (both sides of the 1e-3 rad
    small-angle branches of log3 and jlog3)."""
    q, v, tau = perturbed_states(env, batch, seed, device=device, dtype=torch.float64)
    model, rng = env.robot.model, np.random.default_rng(seed + 1)
    q = q.cpu().numpy()
    half = batch // 2
    for j in env.robot.flexibility.joint_indices:
        quat = rng.normal(size=(batch, 4))
        axis = rng.normal(size=(batch - half, 3))
        axis /= np.linalg.norm(axis, axis=1, keepdims=True)
        angle = 10.0 ** rng.uniform(-4.0, -2.0, size=(batch - half, 1))
        quat[half:] = np.concatenate([axis * np.sin(angle / 2), np.cos(angle / 2)], axis=1)
        q[:, model.q_slice(j)] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    dtype = env.dtype if dtype is None else dtype
    return torch.as_tensor(q, device=v.device).to(dtype), v.to(dtype), tau.to(dtype)


def rough_ground():
    """The rough ground of the terrain cell: jiminy_tpu's own fused-terrain
    case (its tests/test_cdyn.py::test_cdyn_terrain_matches_generic), a
    4-octave Perlin ground (1.5 m wavelength, 5 cm) plus stairs (3 steps of
    3 cm up and 3 down, 0.4 m wide, turned 0.5 rad), summed."""
    from jiminy_torch.utils import terrain

    return terrain.sum_heightmaps([
        terrain.random_perlin_ground(wavelength=1.5, height_max=0.05, seed=3),
        terrain.periodic_stairs_ground(0.4, 0.03, 3, orientation=0.5),
    ])


def ground_options(options, ground):
    """The options with `ground` as the world's ground profile."""
    return options.replace(world=dataclasses.replace(options.world, ground_profile=ground))


def spread_on_ground(q: torch.Tensor, ground, seed: int, half_width: float = 10.0):
    """States spread over a ground: each env's base (x, y) drawn uniformly
    over a square of side 2 half_width (numpy, from `seed`), its height
    raised by the ground's height under the base, so feet meet the terrain
    at the depths they met flat ground."""
    q = q.clone()
    rng = np.random.default_rng(seed)
    q[:, :2] = torch.as_tensor(rng.uniform(-half_width, half_width, size=(q.shape[0], 2)),
                               dtype=q.dtype, device=q.device)
    h, _ = ground(q[:, :2])
    q[:, 2] = q[:, 2] + h
    return q


def contact_points(env, q: torch.Tensor) -> torch.Tensor:
    """(B, nc, 3) world positions of the env's contact points at q (the
    component core's plain kinematics, on q's device)."""
    eng = env.engine
    cd = eng._cdyn if eng._cdyn is not None else eng._cdyn_cm
    world = cd._world_placements(cd._joint_x([q[:, i] for i in range(q.shape[1])]))
    points = []
    for f in env.robot.contact_frame_indices:
        rw, pw = world[cd.c.frame_parents[f]]
        fp = cd.c.fpos[f]
        points.append(torch.stack(
            [sum(rw[i][k] * fp[k] for k in range(3)) + pw[i] for i in range(3)], -1))
    return torch.stack(points, -2)


def place_on_ground(env, q: torch.Tensor, ground, generator: torch.Generator,
                    half_width: float = 10.0) -> torch.Tensor:
    """States placed on a ground: each env's base (x, y) drawn uniformly
    over a square of side 2 half_width from `generator`, then lifted by the
    largest ground height under its contact points plus 1 mm."""
    q = q.clone()
    xy = (torch.rand((q.shape[0], 2), generator=generator, dtype=torch.float64,
                     device=generator.device) * 2.0 - 1.0) * half_width
    q[:, :2] = xy.to(device=q.device, dtype=q.dtype)
    feet = contact_points(env, q)
    h, _ = ground(feet[..., :2])
    q[:, 2] = q[:, 2] + h.amax(-1) + 1e-3
    return q


def dopri_options(options):
    """The options with the adaptive DOPRI 5(4) integrator (the C++
    reference's `odeSolver = "runge_kutta_dopri5"`)."""
    from jiminy_torch.engine.config import IntegratorType

    return options.replace(
        stepper=dataclasses.replace(options.stepper, integrator=IntegratorType.RUNGE_KUTTA_DOPRI)
    )


def resolving_options(options, dt_max: float = 2.5e-5, period: float = 1.0e-4):
    """The options with an RK4 substep of `dt_max` and controller and sensor
    periods of `period`. jiminy_tpu's flexible ANYmal (`make("anymal-pid",
    flexible=True)`) integrates its flexibility joints' damped mode about the
    shank (damping 1e2 over an inertia of about 1e-3: an eigenvalue near
    -1e5 1/s) with RK4 at 1 ms, 100 times outside RK4's stability interval
    (|lambda dt| < 2.79): rounding noise grows some 4e6-fold a substep and the
    state is non-finite within two controller periods, in jiminy_tpu and in
    the port alike. A substep of 2.5e-5 s resolves that mode."""
    return options.replace(
        stepper=dataclasses.replace(options.stepper, dt_max=dt_max),
        controller_update_period=period, sensor_update_period=period)


def constraint_mode_options(options):
    """The options with ground contacts and joint bounds as PGS rows."""
    from jiminy_torch.engine.config import ContactModel

    return options.replace(
        contacts=dataclasses.replace(options.contacts, model=ContactModel.CONSTRAINT),
        joint_bounds_mode="constraint",
    )


def constrained_inputs(env, batch: int, seed: int, device=None, dtype=None, rows: str = "mixed"):
    """(q, v, cmd, solver) for the constrained kernels: feet 0-3 cm into the
    ground, joint offsets with a quarter of the envs past a joint bound,
    random velocities and motor commands, and the solver channels `[lam (N)
    | contact active (nc) | bound active (nb)]`: multipliers from 0 to 50
    in half the envs (0 in the others) and random 0/1 masks.

    `rows="all"` makes every row active at the first solve (every bounded
    joint just past its upper bound, every foot 1-3 cm deep, all masks 1);
    `rows="none"` makes none active (the base 2 m up, the joints at the
    nominal pose, at least 0.01 rad inside their bounds, masks 0); `rows="standing"` is the robot at rest in its nominal
    pose (feet 1 mm deep, no velocity, contact masks 1, bound masks 0, no
    warm start): the contact rows active, the bound rows not."""
    if rows not in ("mixed", "all", "none", "standing"):
        raise ValueError(f"rows must be 'mixed', 'all', 'none' or 'standing', got {rows!r}")
    device = env.device if device is None else device
    dtype = env.dtype if dtype is None else dtype
    eng = env.engine
    cset = eng.cset
    model = env.robot.model
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(env.nominal_q.cpu(), np.float64), (batch, 1))
    q[:, 2] -= rng.uniform(0.001, 0.031, size=batch)
    q[:, 7:] += rng.normal(size=(batch, model.nq - 7)) * 0.05
    bounds = [model.idx_q[j] for j in cset.bound_joint_indices]
    n_past = batch // 4
    if bounds:
        qi = np.asarray(bounds)[rng.integers(0, len(bounds), size=n_past)]
        hi = np.asarray(model.position_limit_upper)[qi]
        q[np.arange(n_past), qi] = np.where(np.isfinite(hi), hi + 0.05, q[np.arange(n_past), qi])
    v = rng.normal(size=(batch, model.nv)) * 0.3
    cmd = rng.normal(size=(batch, env.robot.nmotors)) * 20.0
    lam = rng.uniform(0.0, 50.0, size=(batch, cset.total_rows)) * (rng.uniform(size=(batch, 1)) < 0.5)
    masks = (rng.uniform(size=(batch, cset.n_contacts + cset.n_bounds)) < 0.5).astype(np.float64)
    if rows == "all":  # joints just past their upper bounds, every foot 1-3 cm deep
        hi = np.asarray(model.position_limit_upper)[bounds]
        q[:, bounds] = hi + rng.uniform(0.0005, 0.003, size=(batch, len(bounds)))
        q[:, 2] -= _highest_foot(eng, q) + rng.uniform(0.01, 0.03, size=batch)
        masks[:] = 1.0
    elif rows == "none":
        q[:, 2] += 2.0
        q[:, 7:] = np.asarray(env.nominal_q.cpu(), np.float64)[7:]
        if bounds:  # a nominal joint at a bound (the Atlas's knees, arms) moved inside it
            lo = np.asarray(model.position_limit_lower)[bounds]
            hi = np.asarray(model.position_limit_upper)[bounds]
            q[:, bounds] = np.clip(q[:, bounds], lo + 0.01, hi - 0.01)
        masks[:] = 0.0
    elif rows == "standing":
        q[:] = np.asarray(env.nominal_q.cpu(), np.float64)
        q[:, 2] -= _highest_foot(eng, q) + 0.001
        v[:] = 0.0
        lam[:] = 0.0
        masks[:, : cset.n_contacts] = 1.0
        masks[:, cset.n_contacts :] = 0.0

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return t(q), t(v), t(cmd), t(np.concatenate([lam, masks], axis=1))


def bound_row_inputs(env, batch: int, seed: int, device=None, dtype=None, rows: str = "mixed"):
    """(q, v, cmd, solver) for the constrained kernels on a fixed-root model
    whose rows are joint bounds only (no contact): joint positions uniform in
    [-pi, pi] (within the bounds), a quarter of the envs with a bounded joint
    just past its upper bound, random velocities, motor commands up to half
    the effort limit, and the solver channels `[lam (N) | bound active
    (nb)]`: multipliers from 0 to 50 in half the envs and random 0/1 masks.
    `rows="all"` puts every bounded joint 0.5-3 mrad past its upper bound
    with every mask 1, `rows="none"` every joint inside its bounds with the
    masks and multipliers 0."""
    if rows not in ("mixed", "all", "none"):
        raise ValueError(f"rows must be 'mixed', 'all' or 'none', got {rows!r}")
    device = env.device if device is None else device
    dtype = env.dtype if dtype is None else dtype
    cset, model = env.engine.cset, env.robot.model
    if cset.n_contacts or any(t not in (1, 3) for t in model.joint_types):
        raise ValueError("bound_row_inputs takes fixed-root models with joint-bound rows only")
    rng = np.random.default_rng(seed)
    lo = np.asarray(model.position_limit_lower, np.float64)
    hi = np.asarray(model.position_limit_upper, np.float64)
    q = np.clip(rng.uniform(-math.pi, math.pi, size=(batch, model.nq)), lo, hi)
    bounds = np.asarray([model.idx_q[j] for j in cset.bound_joint_indices], dtype=np.int64)
    n_past = batch // 4
    if rows == "mixed" and len(bounds):
        qi = bounds[rng.integers(0, len(bounds), size=n_past)]
        q[np.arange(n_past), qi] = hi[qi] + 0.05
    elif rows == "all":
        q[:, bounds] = hi[bounds] + rng.uniform(0.0005, 0.003, size=(batch, len(bounds)))
    v = rng.normal(size=(batch, model.nv))
    effort = np.asarray(env.robot.motors.effort_limit, np.float64)
    cmd = rng.uniform(-0.5, 0.5, size=(batch, env.robot.nmotors)) * effort
    lam = rng.uniform(0.0, 50.0, size=(batch, cset.total_rows)) * (rng.uniform(size=(batch, 1)) < 0.5)
    masks = (rng.uniform(size=(batch, cset.n_bounds)) < 0.5).astype(np.float64)
    if rows == "all":
        masks[:] = 1.0
    elif rows == "none":
        lam[:] = 0.0
        masks[:] = 0.0

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return t(q), t(v), t(cmd), t(np.concatenate([lam, masks], axis=1))


def _highest_foot(eng, q: np.ndarray) -> np.ndarray:
    """Height of the highest contact point per env, a sphere's lowest point
    (float64, on the CPU)."""
    cd = eng._cdyn_cm
    qt = torch.as_tensor(q, dtype=torch.float64)
    world = cd._world_placements(cd._joint_x([qt[:, i] for i in range(qt.shape[1])]))
    heights = []
    radii = eng.cset.contact_radii or (0.0,) * eng.cset.n_contacts
    for f, r in zip(eng.cset.contact_frame_indices, radii):
        rw, pw = world[cd.c.frame_parents[f]]
        fp = cd.c.fpos[f]
        heights.append(sum(rw[2][k] * fp[k] for k in range(3)) + pw[2] - r)
    return torch.stack(heights, -1).amax(-1).numpy()


def _columns(x: torch.Tensor) -> torch.Tensor:
    x = x.double()
    return x.reshape(-1, x.shape[-1]) if x.dim() else x.reshape(1, 1)


def column_errors(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per output column (last axis): max over envs of |out - ref| divided by
    (1 + max over envs of |ref|). Each column is held to its own scale, so a
    small output is not hidden behind a large one."""
    out, ref = _columns(out), _columns(ref)
    return (out - ref).abs().amax(0) / (1.0 + ref.abs().amax(0))


def column_quantile_errors(out: torch.Tensor, ref: torch.Tensor, q: float = 0.9) -> torch.Tensor:
    """Per output column: the q-quantile over envs of |out - ref| divided by
    the column's typical magnitude, the RMS of `ref` over envs (1 where that
    is 0). A zeroed column scores about 1, as does one wrong in more than a
    share 1 - q of the envs; the rare env whose float32 answer a rounding
    flip of a contact or bound branch moves far does not decide it."""
    out, ref = _columns(out), _columns(ref)
    rms = ref.pow(2).mean(0).sqrt()
    rms = torch.where(rms > 0, rms, torch.ones_like(rms))
    err = (out - ref).abs() / rms
    k = min(err.shape[0], max(1, math.ceil(q * err.shape[0])))
    return torch.kthvalue(err, k, dim=0).values


def _fourbar_joint(name, parent, placement_z, x=0.0, com_z=-0.25, mass=0.5, limit=None):
    from jiminy_torch.models.joints import JointType

    spec = {
        "name": name, "type": JointType.REVOLUTE, "parent": parent,
        "axis": np.array([0.0, 1.0, 0.0]),
        "placement": (np.eye(3), np.array([x, 0.0, placement_z])),
        "mass": mass, "com": np.array([0.0, 0.0, com_z]), "inertia": np.eye(3) * 1e-3,
    }
    if limit is not None:
        spec["position_limit"] = (np.array([-limit]), np.array([limit]))
    return spec


def fourbar_robot(contacts: bool = False):
    """jiminy_tpu's Cassie-shaped test models (`tests/test_cdyn.py:343-485`):
    two revolute links and a third closed onto the second's tip by a
    distance loop, one motor on the first joint. With `contacts` the
    linkage hangs 0.6 m up with a spring-damper foot below the second link
    and the first joint bounded to +-1 rad (`fourbar_c`)."""
    from jiminy_torch.engine.robot import Robot
    from jiminy_torch.models.model import build_model

    def frame(name, parent, z):
        return {"name": name, "parent": parent, "placement": (np.eye(3), np.array([0.0, 0.0, z]))}

    if contacts:
        joints = [
            _fourbar_joint("j0", -1, 0.6, mass=1.0, limit=1.0),
            _fourbar_joint("j1", 0, -0.35, com_z=-0.15),
            _fourbar_joint("j2", -1, 0.6, x=0.15, com_z=-0.15),
        ]
        frames = [frame("tip_a", 1, -0.3), frame("tip_b", 2, -0.3), frame("foot", 1, -0.32)]
    else:
        joints = [
            _fourbar_joint("j0", -1, 0.0, mass=1.0),
            _fourbar_joint("j1", 0, -0.5),
            _fourbar_joint("j2", -1, 0.0, x=0.3),
        ]
        frames = [frame("tip_a", 1, -0.5), frame("tip_b", 2, -0.5)]
    model = build_model("fourbar_c" if contacts else "fourbar", joints, frames)
    return Robot.build(model, motors=[{"joint_name": "j0"}],
                       contact_frames=["foot"] if contacts else [],
                       loop_constraints=[("tip_a", "tip_b")])


def fourbar_options(contacts: bool = False):
    """The engine options of jiminy_tpu's four-bar tests: RK4 at 1 ms; with
    the foot a stiff spring-damper contact and penalty joint bounds."""
    from jiminy_torch.engine.config import ContactOptions, EngineOptions, StepperOptions

    if not contacts:
        return EngineOptions(stepper=StepperOptions(dt_max=1e-3))
    return EngineOptions(contacts=ContactOptions(stiffness=2e4, damping=4e2, friction=1.0),
                         stepper=StepperOptions(dt_max=1e-3), joint_bounds_mode="penalty")


def loop_inputs(eng, q0, batch: int, seed: int, device=None, dtype=None, drop: float = 0.03):
    """(q, v, cmd, cc_tail) for the constrained kernels of a robot with loop
    closures beside spring-damper contacts: `q0` perturbed (joints by 0.05
    rad; a floating base lowered 0 to `drop` m, so that some contact points
    touch), random velocities and motor commands, and the command row's tail
    `[distance_ref (nd) | lam (N) | contact active (nc) | bound active
    (nb)]`: the loops' lengths at `q0` give or take 1 cm, multipliers from
    -50 to 50 in half the envs (0 in the others), random 0/1 masks."""
    from jiminy_torch.engine.constraints import compute_distance_refs
    from jiminy_torch.ops.kinematics import forward_kinematics

    device = eng.device if device is None else device
    dtype = eng.dtype if dtype is None else dtype
    model, cset = eng.robot.model, eng.cset
    rng = np.random.default_rng(seed)
    q0 = np.asarray(q0, np.float64)
    q = np.tile(q0, (batch, 1))
    free = model.nq != model.nv
    first = 7 if free else 0
    q[:, first:] += rng.normal(size=(batch, model.nq - first)) * 0.05
    if free:
        q[:, 2] -= rng.uniform(0.0, drop, size=batch)
    v = rng.normal(size=(batch, model.nv)) * 0.3
    cmd = rng.normal(size=(batch, eng.robot.nmotors)) * 5.0
    dref = compute_distance_refs(model, cset, forward_kinematics(
        model, torch.as_tensor(q0, dtype=torch.float64))).numpy()
    dref = dref + rng.uniform(-0.01, 0.01, size=(batch, cset.n_distance))
    lam = rng.uniform(-50.0, 50.0, size=(batch, cset.total_rows)) * (
        rng.uniform(size=(batch, 1)) < 0.5)
    masks = (rng.uniform(size=(batch, cset.n_contacts + cset.n_bounds)) < 0.5).astype(np.float64)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return t(q), t(v), t(cmd), t(np.concatenate([dref, lam, masks], axis=1))
