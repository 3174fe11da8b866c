"""Inputs for holding the kernels against their plain versions.

`perturbed_states` draws (q, v, tau) around an env's nominal pose from a numpy
seed: the base lowered so that some feet penetrate the ground, random joint
offsets with some joints pushed past their bounds, a tilted base, random
velocities and torques. `constrained_inputs` draws the same kind of states
for the constrained (PGS) path, with every foot 0-3 cm into the ground and
the solver channels (warm-start multipliers, active sets) that ride the
command row and the carry, or with every row, no row or the contact rows of
a robot at rest active. `column_errors` and `column_quantile_errors`
hold a kernel's outputs against its plain version column by column. The
card tests and `chip_smoke.py` use them. `constraint_mode_options` turns an
env's engine options into constraint contact mode, as `bench.py` does with
`BENCH_CONTACT=constraint`; `dopri_options` turns them to adaptive DOPRI
5(4), every other option kept.
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


def dopri_options(options):
    """The options with the adaptive DOPRI 5(4) integrator (the C++
    reference's `odeSolver = "runge_kutta_dopri5"`)."""
    from jiminy_torch.engine.config import IntegratorType

    return options.replace(
        stepper=dataclasses.replace(options.stepper, integrator=IntegratorType.RUNGE_KUTTA_DOPRI)
    )


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
    `rows="none"` makes none active (the base 2 m up, joints inside their
    bounds, masks 0); `rows="standing"` is the robot at rest in its nominal
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


def _highest_foot(eng, q: np.ndarray) -> np.ndarray:
    """Height of the highest contact point per env (float64, on the CPU)."""
    cd = eng._cdyn_cm
    qt = torch.as_tensor(q, dtype=torch.float64)
    world = cd._world_placements(cd._joint_x([qt[:, i] for i in range(qt.shape[1])]))
    heights = []
    for f in eng.cset.contact_frame_indices:
        rw, pw = world[cd.c.frame_parents[f]]
        fp = cd.c.fpos[f]
        heights.append(sum(rw[2][k] * fp[k] for k in range(3)) + pw[2])
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
