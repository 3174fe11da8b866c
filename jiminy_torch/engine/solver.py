"""Constrained forward dynamics by projected Gauss-Seidel over the Delassus
matrix A = J M^-1 J^T (port of `jiminy_tpu.engine.solver`: the array form
of the generic path and the component path), and the two CUDA kernels that
replace the constrained bodies of its Pallas kernels.

The array form. `constrained_forward_dynamics` takes a `ConstraintSystem`
(`engine/constraints.py`): M from `crba`, nle from `nonlinear_effects`
(external forces included), a Cholesky factor of M
(`torch.linalg.cholesky_ex`, `solve_triangular`, as jiminy_tpu runs them in
XLA outside its kernels), and `pgs_solve` over the (..., N, N) Delassus
matrix. It is the generic path's solve (`Engine.dynamics_full`), plain
torch on every device.

Plain versions. `constrained_accel_full_components` mirrors jiminy_tpu's
function of the same name: component CRBA and RNEA (with the spring-damper
ground forces of the core's contacts, if it has any, as external forces),
an LDL^T factor of the mass matrix, the bound, ground-contact and
distance-loop rows with their Baumgarte drifts and active-set hysteresis, A
with its diagonal regularization, and a fixed number of boxed/cone
Gauss-Seidel sweeps warm-started from the carried multipliers. The
right-hand sides of the N constraint rows are solved together: each
component of them is one (N, *batch) tensor, and A, b and the multipliers
are (N, N, *batch) and (N, *batch) tensors. Every sum runs
in jiminy_tpu's order, except the Gauss-Seidel row dot, one reduction per
row here and a sequential sum in jiminy_tpu and the kernels (they differ in
rounding). `ConstrainedPeriodIntegrator` and `ConstrainedRolloutIntegrator`
mirror the closures of `make_constrained_period_integrator` and
`make_constrained_rollout_integrator`.

Kernels (`csrc/pgs.cuh`, instantiated in `csrc/cdyn.cu`):

- `cdyn_period_cm` replaces the constrained body of
  `jiminy_tpu/ops/cdyn.py::_pallas_period_fn` (`thread_cc=True`);
- `cdyn_rollout_cm` replaces the constrained body of `_pallas_rollout_fn`
  (`thread_cc=True` with the end-of-tick warm-start refresh).

They run a group of lanes per env with everything an env keeps in a
shared-memory slice sized from the model, solving the active rows alone
over each row's support dofs; `pack_constraints` packs those supports,
`cm_smem_per_env` sizes each env's slice and `cm_geometry` picks the envs a
block. Any row count and any model size is taken; a launch whose block the
card refuses raises.

Joint bounds, ground contacts (points and spheres), distance loops and
rolling rows are ported, beside spring-damper ground contacts and penalty
joint bounds, on flat ground or on a ground profile (`cd.ground_fn`; the
kernels evaluate its packed form, `utils.terrain`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from jiminy_torch.engine.constraints import ConstraintSet, ConstraintSystem
from jiminy_torch.models import joints as jt
from jiminy_torch.models.model import RobotModel
from jiminy_torch.ops import cdyn
from jiminy_torch.ops import dynamics as dyn
from jiminy_torch.ops import lie
from jiminy_torch.ops.cdyn import m_mv, m_tv, v_add, v_cross, v_dot, v_scale, v_sub

_MIN_REGULARIZER = 1.0e-11
_RELAX_MIN = 0.01
_RELAX_MAX = 1.0
_RELAX_MIN_ITER_NUM = 20
_RELAX_MAX_ITER_NUM = 30


def _lit0(x) -> bool:
    """True for a Python literal zero (a structural zero of a row)."""
    return isinstance(x, (int, float)) and x == 0.0


def _relaxation(iter_idx: int, iter_max: int) -> float:
    """Under-relaxation factor of sweep `iter_idx` (reference
    `constraint_solvers.cc:245-258`), the 50/30/20 split of full relaxation,
    quadratic ramp and minimum scaled down below 50 iterations."""
    min_num, max_num = _RELAX_MIN_ITER_NUM, _RELAX_MAX_ITER_NUM
    if iter_max < min_num + max_num:
        min_num = max(int(round(0.2 * iter_max)), 1)
        max_num = max(int(round(0.3 * iter_max)), 1)
    denom = max(iter_max - min_num - max_num, 1)
    ratio = ((iter_max - min_num) - iter_idx) / denom
    if ratio >= 1.0:
        return _RELAX_MAX
    clipped = min(max(ratio, 0.0), 1.0)
    return _RELAX_MIN + (_RELAX_MAX - _RELAX_MIN) * clipped * clipped


def _pgs_sweep_components(cset: ConstraintSet, a, b, lam0, friction: float,
                          torsion: float, iter_max: int):
    """The boxed/cone Gauss-Seidel sweeps: distance and rolling rows plain
    GS, then bounds and the contact normal, torsion and tangent levels with
    under-relaxation and cone projection (reference
    `ProjectedGaussSeidelIter`, `constraint_solvers.cc:107-222`).

    a: (N, N, *batch) symmetric; b, lam0: (N, *batch). Returns (N, *batch)."""
    off_b, off_c, off_d, off_r = cset.row_offsets()
    x = lam0.clone()

    def dot_col(i):
        return (a[:, i] * x).sum(0)

    for it in range(iter_max):
        w = _relaxation(it, iter_max)
        for i in [off_d + k for k in range(cset.n_distance)] + [
            off_r + k for k in range(3 * cset.n_rolling)
        ]:
            x[i] = x[i] + (b[i] - dot_col(i)) / a[i, i]
        for i in [off_b + k for k in range(cset.n_bounds)] + [
            off_c + 4 * k + 2 for k in range(cset.n_contacts)
        ]:
            y = b[i] - dot_col(i)
            x[i] = torch.clamp(x[i] + w * y / a[i, i], min=0.0)
        # level 1: torsional friction |lam_rz| <= torsion * lam_z
        for k in range(cset.n_contacts):
            i, iz = off_c + 4 * k + 3, off_c + 4 * k + 2
            if torsion <= 0.0:
                x[i] = 0.0
                continue
            y = b[i] - dot_col(i)
            thr = torsion * x[iz]
            x[i] = cdyn._clip(x[i] + w * y / a[i, i], -thr, thr)
        # level 2: tangential friction cone ||lam_xy|| <= mu lam_z
        for k in range(cset.n_contacts):
            i0 = off_c + 4 * k
            i1, iz = i0 + 1, i0 + 2
            if friction <= 0.0:
                x[i0] = 0.0
                x[i1] = 0.0
                continue
            y0 = b[i0] - dot_col(i0)
            y1 = b[i1] - dot_col(i1)
            a_max = torch.maximum(a[i0, i0], a[i1, i1])
            x0 = x[i0] + w * y0 / a_max
            x1 = x[i1] + w * y1 / a_max
            thr = friction * x[iz]
            norm2 = x0 * x0 + x1 * x1
            scale = torch.where(
                norm2 > thr * thr, thr / torch.sqrt(torch.clamp(norm2, min=1e-30)), 1.0
            )
            x[i0] = x0 * scale
            x[i1] = x1 * scale
    return x


def pgs_solve(cset: ConstraintSet, A: torch.Tensor, b: torch.Tensor, lam0: torch.Tensor,
              friction: float, torsion: float, iter_max: int,
              componentwise: bool = False) -> torch.Tensor:
    """Fixed-iteration PGS with boxed bounds and friction-cone projection:
    A (..., N, N), b and the warm start lam0 (..., N) -> (..., N).
    `componentwise=True` runs the component sweep (`_pgs_sweep_components`)
    on the same rows."""
    if not componentwise:
        return _pgs_solve_einsum(cset, A, b, lam0, friction, torsion, iter_max)
    lam = _pgs_sweep_components(
        cset, torch.movedim(A, (-2, -1), (0, 1)), torch.movedim(b, -1, 0),
        torch.movedim(lam0.expand(b.shape), -1, 0), friction, torsion, iter_max,
    )
    return torch.movedim(lam, 0, -1)


def _pgs_solve_einsum(cset: ConstraintSet, A, b, lam0, friction: float, torsion: float,
                      iter_max: int) -> torch.Tensor:
    """Array-form PGS: the rows' sweep order and projections of
    `_pgs_sweep_components`, each row's dot one reduction over A's column."""
    off_b, off_c, off_d, off_r = cset.row_offsets()
    x = lam0.expand(b.shape).clone()

    def dot_col(i):
        return lie.mv(A[..., :, i].unsqueeze(-2), x)[..., 0]

    for it in range(iter_max):
        w = _relaxation(it, iter_max)
        for i in [off_d + k for k in range(cset.n_distance)] + [
            off_r + k for k in range(3 * cset.n_rolling)
        ]:
            x[..., i] = x[..., i] + (b[..., i] - dot_col(i)) / A[..., i, i]
        for i in [off_b + k for k in range(cset.n_bounds)] + [
            off_c + 4 * k + 2 for k in range(cset.n_contacts)
        ]:
            y = b[..., i] - dot_col(i)
            x[..., i] = torch.clamp(x[..., i] + w * y / A[..., i, i], min=0.0)
        for k in range(cset.n_contacts):
            i, iz = off_c + 4 * k + 3, off_c + 4 * k + 2
            if torsion <= 0.0:
                x[..., i] = 0.0
                continue
            y = b[..., i] - dot_col(i)
            thr = torsion * x[..., iz]
            x[..., i] = cdyn._clip(x[..., i] + w * y / A[..., i, i], -thr, thr)
        for k in range(cset.n_contacts):
            i0 = off_c + 4 * k
            i1, iz = i0 + 1, i0 + 2
            if friction <= 0.0:
                x[..., i0] = 0.0
                x[..., i1] = 0.0
                continue
            y0 = b[..., i0] - dot_col(i0)
            y1 = b[..., i1] - dot_col(i1)
            a_max = torch.maximum(A[..., i0, i0], A[..., i1, i1])
            x0 = x[..., i0] + w * y0 / a_max
            x1 = x[..., i1] + w * y1 / a_max
            thr = friction * x[..., iz]
            norm2 = x0 * x0 + x1 * x1
            scale = torch.where(
                norm2 > thr * thr, thr / torch.sqrt(torch.clamp(norm2, min=1e-30)), 1.0
            )
            x[..., i0] = x0 * scale
            x[..., i1] = x1 * scale
    return x


@dataclasses.dataclass
class ConstrainedDynamicsResult:
    qdd: torch.Tensor  # (..., nv)
    lam: torch.Tensor  # (..., N) multipliers (constraint-space forces)


def constrained_forward_dynamics(model: RobotModel, gravity, q: torch.Tensor, v: torch.Tensor,
                                 tau: torch.Tensor, fext, csys: ConstraintSystem,
                                 cset: ConstraintSet, lam_warm: torch.Tensor, friction: float,
                                 torsion: float, regularization: float,
                                 iter_max: int) -> ConstrainedDynamicsResult:
    """qdd = M^-1 (J^T lam + tau - nle), lam from PGS over A = J M^-1 J^T +
    reg (reference `SolveBoxedForwardDynamics`). Inactive rows are masked to
    a zero Jacobian and drift, so they carry no force."""
    mass_matrix = dyn.crba(model, q)  # armature included
    nle = dyn.nonlinear_effects(model, gravity, q, v, fext)
    chol = torch.linalg.cholesky_ex(mass_matrix)[0]  # no host sync (CUDA graphs)

    def minv(x):
        vec = x.ndim == q.ndim
        if vec:
            x = x[..., None]
        y = torch.linalg.solve_triangular(chol, x, upper=False)
        y = torch.linalg.solve_triangular(chol.transpose(-1, -2), y, upper=True)
        return y[..., 0] if vec else y

    mask = csys.active.to(q.dtype)
    jac = csys.jac * mask[..., None]
    drift = csys.drift * mask

    tau_res = minv(tau - nle)
    minv_jt = minv(jac.transpose(-1, -2))  # (..., nv, N)
    A = lie.mm(jac, minv_jt)
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    reg = torch.clamp(diag * regularization, min=_MIN_REGULARIZER)
    A = A + torch.diag_embed(reg)
    b = -drift - lie.mv(jac, tau_res)
    b = b * mask
    lam = pgs_solve(cset, A, b, lam_warm * mask, friction, torsion, iter_max)
    qdd = minv(lie.mv(jac.transpose(-1, -2), lam)) + tau_res
    return ConstrainedDynamicsResult(qdd=qdd, lam=lam)


def _ldl_factor_components(a):
    """LDL^T factor of a symmetric matrix given as an n x n nested list of
    components. Returns (l, dinv)."""
    n = len(a)
    l = [[None] * n for _ in range(n)]
    dinv = [None] * n
    d = [None] * n
    for j in range(n):
        dj = a[j][j]
        for k in range(j):
            dj = dj - l[j][k] * l[j][k] * d[k]
        d[j] = dj
        dinv[j] = 1.0 / dj
        for i in range(j + 1, n):
            s_ij = a[i][j]
            for k in range(j):
                s_ij = s_ij - l[i][k] * l[j][k] * d[k]
            l[i][j] = s_ij * dinv[j]
    return l, dinv


def _ldl_solve_components(l, dinv, rhs):
    """Solve with a `_ldl_factor_components` factor. The components of
    `rhs` may carry leading right-hand-side axes ((N, *batch) for N systems
    at once); literal zeros are skipped (exact for finite operands)."""
    n = len(dinv)
    y = list(rhs)
    for i in range(n):
        for k in range(i):
            if not _lit0(y[k]):
                y[i] = y[i] - l[i][k] * y[k]
    for i in range(n):
        if not _lit0(y[i]):
            y[i] = y[i] * dinv[i]
    for i in reversed(range(n)):
        for k in range(i + 1, n):
            if not _lit0(y[k]):
                y[i] = y[i] - l[k][i] * y[k]
    return y


def _normal_basis_components(n):
    """Right-handed basis with column 2 = the (normalized) ground normal
    (reference `FrameConstraint::setNormal`). `n`: three tensors. Returns
    the columns (c0, c1, n)."""
    nx, ny, nz = n
    c1 = [torch.zeros_like(nx + ny), nz, -ny]  # cross(n, ex)
    c1_alt = [-nz, torch.zeros_like(nx), nx]  # cross(n, ey), if n ~ ex
    nrm = torch.sqrt(torch.clamp(v_dot(c1, c1), min=0.0))
    use_alt = nrm < 1e-6
    c1 = [torch.where(use_alt, p, q) for p, q in zip(c1_alt, c1)]
    nrm = torch.sqrt(torch.clamp(v_dot(c1, c1), min=0.0))
    c1 = v_scale(c1, 1.0 / torch.clamp(nrm, min=1e-12))
    c0 = v_cross(c1, n)
    return c0, c1, list(n)


def _flat_ground_normal(like: torch.Tensor):
    """+z as components shaped like `like` (fills: no host copy, so a solve
    can be captured in a CUDA graph)."""
    return [torch.zeros_like(like), torch.zeros_like(like), torch.ones_like(like)]


def _skew_mat(vec, scale=1.0):
    """scale * skew(vec) as a nested list (Python floats stay floats)."""
    return [
        [0.0, -scale * vec[2], scale * vec[1]],
        [scale * vec[2], 0.0, -scale * vec[0]],
        [-scale * vec[1], scale * vec[0], 0.0],
    ]


def constraint_system_components(cd, cset, qc, vc, xs, world, vel, acc, kp: float, kd: float,
                                 transition_eps: float, prev_cact, prev_bact, drefc=(),
                                 rollrefc=()):
    """Joint-bound, ground-contact (points and spheres), distance-loop and
    rolling rows (jiminy_tpu's `constraint_system_components`), on flat
    ground or on the ground `cd.ground_fn`; `drefc` the loops' lengths,
    `rollrefc` the rolling frames' reference heights.

    Returns `(rows [N][nv], drifts [N], basis [nc] (c0, c1, n), depth [nc],
    cact [nc], bact [nb])`, rows and drifts already masked by activity; a
    row's entries off its support dofs are Python 0.0."""
    model = cd.model
    c = cd.c
    nv = model.nv
    lo_all = np.asarray(model.position_limit_lower, dtype=np.float64)
    hi_all = np.asarray(model.position_limit_upper, dtype=np.float64)
    rows, drifts = [], []

    bact = []
    for k, j in enumerate(cset.bound_joint_indices):
        qi, vi = model.idx_q[j], model.idx_v[j]
        qj, vj = qc[qi], vc[vi]
        lo, hi = float(lo_all[qi]), float(hi_all[qi])
        over = qj > hi
        raw = over | (qj < lo)
        inside = (qj > lo + transition_eps) & (qj < hi - transition_eps)
        act = raw | (prev_bact[k] & ~inside)
        bact.append(act)
        sign = torch.where(over, -1.0, 1.0).to(qj.dtype)
        row = [0.0] * nv
        row[vi] = torch.where(act, sign, 0.0)
        dq = qj - cdyn._clip(qj, lo, hi)
        g = sign * (kp * dq + kd * vj)
        rows.append(row)
        drifts.append(torch.where(act, g, 0.0))

    basis_all, depth_all, cact = [], [], []
    radii = cset.contact_radii or (0.0,) * cset.n_contacts
    for k, fidx in enumerate(cset.contact_frame_indices):
        radius = radii[k]
        parent = c.frame_parents[fidx]
        fp = c.fpos[fidx]
        rw, pw = world[parent]
        pc = v_add(m_mv(rw, fp), pw)
        if cd.ground_fn is None:
            n = [0.0, 0.0, 1.0]  # flat ground: height 0, unit normal
            depth = (pc[2] - 0.0) * n[2]
            basis = _normal_basis_components(_flat_ground_normal(depth))
        else:
            h, n = cdyn.ground_components(cd.ground_fn, pc[0], pc[1])
            nn = torch.clamp(torch.sqrt(v_dot(n, n)), min=1e-12)
            n = v_scale(n, 1.0 / nn)
            depth = (pc[2] - h) * n[2]
            basis = _normal_basis_components(n)
        if radius > 0.0:
            depth = depth - radius
        act = (depth < 0.0) | (prev_cact[k] & (depth <= transition_eps))
        cact.append(act)
        depth_all.append(depth)
        c0, c1, n_col = basis
        basis_all.append((c0, c1, n_col))

        ang_cols, lin_cols = cd._frame_jacobian_cols(world, parent, pc)
        sk = None
        if radius > 0.0:
            # A sphere: the surface point at -r n (skewRadius = r skew(n),
            # reference `sphere_constraint.cc`)
            sk = _skew_mat(n, radius)
            lin_cols = {d: v_add(lin_cols[d], m_mv(sk, ang_cols[d])) for d in lin_cols}
        w_l, v_l = vel[parent]
        a_l = acc[parent]
        vw_ang = m_mv(rw, w_l)
        vw_lin = m_mv(rw, v_add(v_l, v_cross(w_l, fp)))
        aw_ang = m_mv(rw, a_l[0])
        aw_lin = v_add(m_mv(rw, v_sub(a_l[1], v_cross(fp, a_l[0]))), v_cross(vw_ang, vw_lin))
        if sk is not None:
            vw_lin = v_add(vw_lin, m_mv(sk, vw_ang))
            aw_lin = v_add(aw_lin, m_mv(sk, aw_ang))
        # Baumgarte: delta position = depth n, delta rotation = 0
        g_lin = [aw_lin[i] + kp * depth * n[i] + kd * vw_lin[i] for i in range(3)]
        g_ang = [aw_ang[i] + kd * vw_ang[i] for i in range(3)]

        def mask(x, act=act):
            return torch.where(act, x, 0.0)

        for bcol in (c0, c1, n_col):  # tangent0, tangent1, normal rows
            row = [0.0] * nv
            for d, col in lin_cols.items():
                row[d] = mask(v_dot(bcol, col))
            rows.append(row)
            drifts.append(mask(v_dot(bcol, g_lin)))
        row = [0.0] * nv  # torsion row: normal component of the angular part
        for d, col in ang_cols.items():
            row[d] = mask(v_dot(n_col, col))
        rows.append(row)
        drifts.append(mask(v_dot(n_col, g_ang)))
    if cset.n_distance:
        d_rows, d_drifts = cd.distance_rows_components(world, vel, acc, cset.distance_pairs,
                                                       drefc, kp, kd)
        rows += d_rows
        drifts += d_drifts

    # Rolling constraints (spheres, then wheels): the contact point's
    # velocity is zero, 3 unbounded rows each
    n_up = [0.0, 0.0, 1.0]
    specs = [(f, r, None) for f, r in cset.sphere_specs] + list(cset.wheel_specs)
    for slot, (fidx, radius, axis) in enumerate(specs):
        parent = c.frame_parents[fidx]
        fp = c.fpos[fidx]
        rw, pw = world[parent]
        pc = v_add(m_mv(rw, fp), pw)
        w_l, v_l = vel[parent]
        a_l = acc[parent]
        w_w = m_mv(rw, w_l)
        v_w = m_mv(rw, v_add(v_l, v_cross(w_l, fp)))
        a_ang = m_mv(rw, a_l[0])
        a_lin = v_add(m_mv(rw, v_sub(a_l[1], v_cross(fp, a_l[0]))), v_cross(w_w, v_w))
        ang_cols, lin_cols = cd._frame_jacobian_cols(world, parent, pc)
        if axis is None:
            sk = _skew_mat(n_up, radius)
            delta = pc[2] - rollrefc[slot]
            extra = None
        else:
            # The wheel's axis in its joint's coordinates is static
            ax_p = (np.asarray(c.frot[fidx], np.float64) @ np.asarray(axis, np.float64)).tolist()
            axis_w = m_mv(rw, ax_p)
            x = v_cross(v_cross(axis_w, n_up), axis_w)
            x_norm = torch.clamp(torch.sqrt(torch.clamp(v_dot(x, x), min=0.0)), min=1e-9)
            y = v_scale(x, 1.0 / x_norm)
            sk = _skew_mat(y, radius)
            delta = pc[2] - rollrefc[slot] + radius * (n_up[2] - y[2])
            daxis = v_cross(w_w, axis_w)
            dx = v_add(v_cross(v_cross(daxis, n_up), axis_w),
                       v_cross(v_cross(axis_w, n_up), daxis))
            z = v_scale(dx, 1.0 / x_norm)
            dy = v_sub(z, v_scale(y, v_dot(y, z)))
            extra = m_mv(_skew_mat(dy, radius), w_w)
        vel_pt = v_add(v_w, m_mv(sk, w_w))
        ska = m_mv(sk, a_ang)
        acc_pt = v_add(a_lin, ska) if extra is None else [
            a_lin[i] + ska[i] + extra[i] for i in range(3)]
        g = [acc_pt[i] + kp * delta * n_up[i] + kd * vel_pt[i] for i in range(3)]
        for i in range(3):
            row = [0.0] * nv
            for d in lin_cols:
                row[d] = v_add(lin_cols[d], m_mv(sk, ang_cols[d]))[i]
            rows.append(row)
            drifts.append(g[i])
    return rows, drifts, basis_all, depth_all, cact, bact


def _stack_rows(comps, batch, like: torch.Tensor) -> torch.Tensor:
    """Stack components (tensors or Python floats) on a leading axis."""
    return torch.stack([
        x.to(like.dtype).expand(batch) if isinstance(x, torch.Tensor)
        else like.new_full(batch, float(x))
        for x in comps
    ])


def constrained_accel_full_components(cd, cset, qc, vc, tc, kp: float, kd: float,
                                      transition_eps: float, friction: float, torsion: float,
                                      regularization: float, iter_max: int, prev_cact,
                                      prev_bact, lamc, drefc=(), rollrefc=()):
    """Component-wise constrained forward dynamics for bound, ground
    contact, distance and rolling rows: qdd = M^-1 (tau - nle + J^T lam), lam from
    PGS over A = J M^-1 J^T + reg; nle takes the core's spring-damper
    ground forces, if it has contacts. Returns `(qdd [nv], lam (N, *batch),
    basis, depth, cact, bact)`."""
    nv = cd.model.nv
    n = cset.total_rows
    like = qc[0]
    batch = torch.broadcast_shapes(*(x.shape for x in qc), *(x.shape for x in vc))
    xs = cd._joint_x(qc)
    world = cd._world_placements(xs)
    vel, acc = cd._vel_bias_components(xs, vc)
    rows, drifts, basis, depth, cact, bact = constraint_system_components(
        cd, cset, qc, vc, xs, world, vel, acc, kp, kd, transition_eps, prev_cact, prev_bact, drefc,
        rollrefc,
    )
    mass = cd.mass_matrix_components(qc, xs=xs)
    fext = cd._contact_fext(world, vel)[0] if cd.has_contacts else None
    nle = cd.nle_components(qc, vc, xs=xs, fext=fext)
    l, dinv = _ldl_factor_components(mass)
    tau_res = _ldl_solve_components(l, dinv, [tc[i] - nle[i] for i in range(nv)])

    # All N rows at once: component d of the rows is one (N, *batch) tensor
    jac = [_stack_rows([rows[r][d] for r in range(n)], batch, like) for d in range(nv)]
    minv_jt = _ldl_solve_components(l, dinv, jac)
    a = None
    for d in range(nv):  # sum over dofs in jiminy_tpu's order
        t = jac[d][:, None] * minv_jt[d][None, :]
        a = t if a is None else a + t
    upper = torch.ones((n, n), dtype=torch.bool, device=like.device).triu()
    a = torch.where(upper.reshape((n, n) + (1,) * len(batch)), a, a.transpose(0, 1))
    idx = torch.arange(n, device=like.device)
    diag = a[idx, idx]
    a[idx, idx] = diag + torch.clamp(diag * regularization, min=_MIN_REGULARIZER)
    jt_tau = None
    for d in range(nv):
        t = jac[d] * tau_res[d]
        jt_tau = t if jt_tau is None else jt_tau + t
    b = -_stack_rows(drifts, batch, like) - jt_tau
    # Warm start masked by row activity (inactive rows: zero force; the
    # distance and rolling rows are always active)
    always = torch.ones(batch, dtype=torch.bool, device=like.device)
    act_of_row = (list(bact) + [x for x in cact for _ in range(4)]
                  + [always] * (cset.n_distance + 3 * cset.n_rolling))
    lam0 = torch.where(torch.stack([x.expand(batch) for x in act_of_row]),
                       torch.stack([x.to(like.dtype).expand(batch) for x in lamc]), 0.0)
    lam = _pgs_sweep_components(cset, a, b, lam0, friction, torsion, iter_max)
    minv_jt = torch.stack(minv_jt)  # (nv, N, *batch)
    qdd = None
    for r in range(n):  # J^T lam through M^-1, summed over rows in order
        t = lam[r] * minv_jt[:, r]
        qdd = t if qdd is None else qdd + t
    qdd = [tau_res[k] + qdd[k] for k in range(nv)]
    return qdd, lam, basis, depth, cact, bact


def contact_outputs(cd, cset, qc, lam, basis):
    """Per contact, the world force and the LOCAL contact-frame wrench
    [n(3), f(3)] from the multipliers in the normal basis (reference
    write-back, engine.cc:3770-3857)."""
    _, off_c, _, _ = cset.row_offsets()
    world = cd._world_placements(cd._joint_x(qc))
    fw_rows, wl_rows = [], []
    for k, fidx in enumerate(cset.contact_frame_indices):
        c0, c1, n_col = basis[k]
        lam_b = lam[off_c + 4 * k : off_c + 4 * k + 4]
        f_w = [c0[i] * lam_b[0] + c1[i] * lam_b[1] + n_col[i] * lam_b[2] for i in range(3)]
        n_w = [n_col[i] * lam_b[3] for i in range(3)]
        rw, _ = world[cd.c.frame_parents[fidx]]
        frot = cd.c.frot[fidx]
        fw_rows.append(f_w)
        wl_rows.append([*m_tv(frot, m_tv(rw, n_w)), *m_tv(frot, m_tv(rw, f_w))])
    return fw_rows, wl_rows


# --------------------------------------------------------------------------- #
# Fused constrained period and rollout integrators
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """The constants of the constrained path, from the engine options."""

    kp: float  # Baumgarte stiffness omega^2, omega = 2 pi stabilization_freq
    kd: float  # 2 omega
    transition_eps: float
    friction: float
    torsion: float
    regularization: float
    iter_max: int
    stage_warm_start: bool


def penalty_bound_torques(bound_gains: dict, qc, vc, tc):
    """`tc` with the penalty joint-bound torques added, {vidx: (lo, hi, kp,
    kd, qidx)}: kp (under - over) - kd v while a bound is passed."""
    tc = list(tc)
    for vi, (lo, hi, kp_b, kd_b, qi) in bound_gains.items():
        qj, vj = qc[qi], vc[vi]
        over = torch.clamp(qj - hi, min=0.0)
        under = torch.clamp(lo - qj, min=0.0)
        active = (over > 0.0) | (under > 0.0)
        tc[vi] = tc[vi] + (kp_b * (under - over) - torch.where(active, kd_b * vj, 0.0))
    return tc


def solver_channels(lam, cact, bact) -> list:
    """The warm-start and hysteresis channels `[lam (N) | cact (nc) | bact
    (nb)]` of a solve's outputs, as components."""
    return (list(lam.unbind(0)) + [torch.where(x, 1.0, 0.0) for x in cact]
            + [torch.where(x, 1.0, 0.0) for x in bact])


class _ConstrainedCore:
    """The closures of `make_constrained_period_integrator`: command row
    `[motor command (n_cmd) | distance_ref (nd) | lam (N) | contact active
    (nc) | bound active (nb) | rolling_ref (nr)]`, extras `[a | f_world | w_local | depth | imu
    | lam | cact | bact]`. The contact block of the extras comes from the
    multipliers in constraint contact mode, else from the core's
    spring-damper contacts (one of the two has none); the core's penalty
    bounds (`cd.bound_gains`, empty in constraint contact mode) add to the
    motor torques."""

    def __init__(self, cd, tau_c, cset: ConstraintSet, opts: SolverOptions, dt: float,
                 n_substeps: int, integrator: str, n_cmd: int, imu_frames: tuple):
        if integrator not in cdyn._INTEGRATORS:
            raise ValueError(f"unknown fixed-step integrator {integrator!r}")
        self.cd, self.tau_c, self.cset, self.opts = cd, tau_c, cset, opts
        self.dt, self.n_substeps, self.integrator = float(dt), int(n_substeps), integrator
        self.n_cmd, self.imu_frames = int(n_cmd), tuple(imu_frames)
        nc, nb, n, nd = cset.n_contacts, cset.n_bounds, cset.total_rows, cset.n_distance
        self.n_cc = self.n_cmd + nd + n + nc + nb + cset.n_rolling
        self._packed = {}
        nc_out = nc + (len(cd.contact_frames) if cd.has_contacts else 0)
        self.n_extra = cd.model.nv + 10 * nc_out + 6 * len(self.imu_frames) + n + nc + nb

    def u_c(self, qc, vc, cmd):
        damping = self.cd.c.damping
        tc = self.tau_c(qc, vc, cmd)
        tc = [tc[i] - damping[i] * vc[i] if damping[i] != 0.0 else tc[i]
              for i in range(len(tc))]
        return penalty_bound_torques(self.cd.bound_gains, qc, vc, tc)

    def split_cc(self, cc):
        cset = self.cset
        n, nc, nb, nd = cset.total_rows, cset.n_contacts, cset.n_bounds, cset.n_distance
        off = self.n_cmd + nd
        lamc = cc[off : off + n]
        cactc = [x > 0.5 for x in cc[off + n : off + n + nc]]
        bactc = [x > 0.5 for x in cc[off + n + nc : off + n + nc + nb]]
        rollrefc = cc[off + n + nc + nb :]
        return cc[: self.n_cmd], cc[self.n_cmd : off], lamc, cactc, bactc, rollrefc

    def accel(self, qc, vc, cc):
        cmd, drefc, lamc, cactc, bactc, rollrefc = self.split_cc(cc)
        o = self.opts
        return constrained_accel_full_components(
            self.cd, self.cset, qc, vc, self.u_c(qc, vc, cmd), o.kp, o.kd, o.transition_eps,
            o.friction, o.torsion, o.regularization, o.iter_max, cactc, bactc, lamc, drefc,
            rollrefc,
        )

    def cc_with(self, cc, lam, cact, bact):
        """The command row with its warm-start and hysteresis channels
        replaced by a solver stage's outputs (stage-chained warm start)."""
        nr = self.cset.n_rolling
        return (list(cc[: self.n_cmd + self.cset.n_distance]) + solver_channels(lam, cact, bact)
                + list(cc[len(cc) - nr :]))

    def final_outputs(self, qc, vc, cc):
        ac, lam, basis, depth, cact, bact = self.accel(qc, vc, cc)
        fw_aux, wl_aux, depth_aux, imu = self.cd._aux_components(qc, vc, ac, self.imu_frames)
        extras = list(ac)
        if self.cset.n_contacts:
            fw_rows, wl_rows = contact_outputs(self.cd, self.cset, qc, lam, basis)
        else:
            fw_rows, wl_rows, depth = fw_aux, wl_aux, depth_aux
        for r in fw_rows + wl_rows:
            extras.extend(r)
        extras.extend(depth)
        for r in imu:
            extras.extend(r)
        return extras + solver_channels(lam, cact, bact)

    def substep(self, qc, vc, cc):
        """One integrator substep: `(q', v', cc')`, cc' carrying the last
        stage's multipliers and active sets when stage chaining is on."""
        cd, dt, nv = self.cd, self.dt, self.cd.model.nv
        chain = self.opts.stage_warm_start

        def stage(q, v, cc):
            res = self.accel(q, v, cc)
            return res[0], (self.cc_with(cc, res[1], res[4], res[5]) if chain else cc)

        k1a, cc = stage(qc, vc, cc)
        if self.integrator == "euler":
            q_n = cd.integrate_components(qc, [dt * x for x in vc])
            return q_n, [vc[k] + dt * k1a[k] for k in range(nv)], cc
        q2 = cd.integrate_components(qc, [0.5 * dt * x for x in vc])
        v2 = [vc[k] + 0.5 * dt * k1a[k] for k in range(nv)]
        k2a, cc = stage(q2, v2, cc)
        q3 = cd.integrate_components(qc, [0.5 * dt * x for x in v2])
        v3_ = [vc[k] + 0.5 * dt * k2a[k] for k in range(nv)]
        k3a, cc = stage(q3, v3_, cc)
        q4 = cd.integrate_components(qc, [dt * x for x in v3_])
        v4 = [vc[k] + dt * k3a[k] for k in range(nv)]
        k4a, cc = stage(q4, v4, cc)
        dq = [(dt / 6.0) * (vc[k] + 2.0 * v2[k] + 2.0 * v3_[k] + v4[k]) for k in range(nv)]
        dv = [(dt / 6.0) * (k1a[k] + 2.0 * k2a[k] + 2.0 * k3a[k] + k4a[k]) for k in range(nv)]
        return cd.integrate_components(qc, dq), [vc[k] + dv[k] for k in range(nv)], cc

    def _launch_geometry(self, name, device, dtype, n_action=0, n_block=0) -> tuple:
        packed = self.cd.pack(self.tau_c, self.dt, self.imu_frames, device, dtype)
        cpk = self.pack(device, dtype)
        smem = cm_smem_per_env(packed, cpk, dtype, self.n_cmd, n_action, n_block)
        return (smem,) + cm_geometry(name, packed, cpk, dtype, smem)

    def pack(self, device, dtype) -> "PackedConstraints":
        key = (torch.device(device), dtype)
        packed = self._packed.get(key)
        if packed is None:
            packed = self._packed[key] = pack_constraints(self.cd, self.cset, self.opts,
                                                          device, dtype)
        return packed


class ConstrainedPeriodIntegrator(_ConstrainedCore):
    """One controller period: `(q, v, cc) -> (q', v', extras)`; `plain` and
    `kernel` are callable directly, `__call__` routes by device."""

    def __call__(self, q, v, cc):
        if cdyn._route(q) == "kernel":
            return self.kernel(q, v, cc)
        return self.plain(q, v, cc)

    def plain(self, q, v, cc, n_substeps: Optional[int] = None):
        n_substeps = self.n_substeps if n_substeps is None else n_substeps
        model = self.cd.model
        batch = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1], cc.shape[:-1])
        qc = [q[..., i] for i in range(model.nq)]
        vc = [v[..., i] for i in range(model.nv)]
        ccl = [cc[..., i] for i in range(cc.shape[-1])]
        for _ in range(n_substeps):
            qc, vc, ccl = self.substep(qc, vc, ccl)
        extras = self.final_outputs(qc, vc, ccl)
        return cdyn._stack(qc, batch, q), cdyn._stack(vc, batch, q), cdyn._stack(extras, batch, q)

    def launch_geometry(self, device, dtype) -> tuple:
        """(bytes of shared memory an env, envs a block, envs an SM) of this
        integrator's `cdyn_period_cm` launches."""
        return self._launch_geometry("cdyn_period_cm", device, dtype)

    def kernel(self, q, v, cc, n_substeps: Optional[int] = None):
        n_substeps = self.n_substeps if n_substeps is None else n_substeps
        packed = self.cd.pack(self.tau_c, self.dt, self.imu_frames, q.device, q.dtype)
        return _launch_period_cm(packed, self.pack(q.device, q.dtype), q, v, cc, n_substeps,
                                 cdyn._INTEGRATORS[self.integrator], self.n_cmd, self.n_extra)


class ConstrainedRolloutIntegrator(_ConstrainedCore):
    """One whole env step (the closures of
    `make_constrained_rollout_integrator` on `make_generic_rollout`):
    action row `[env action | distance_ref (nd) | rolling_ref (nr)]`, carry
    `[block carry | lam | cact | bact]`,
    extras = period extras + `[cc_last | carry']`. Each tick runs the
    controller, then the substeps with the command row threaded through
    them, then an end-of-tick solve that refreshes the carried multipliers
    and active sets; the last tick skips that solve."""

    def __init__(self, cd, tau_c, cset, opts, dt, n_substeps, n_ticks, controller, integrator,
                 imu_frames):
        super().__init__(cd, tau_c, cset, opts, dt, n_substeps, integrator, controller.n_cmd,
                         imu_frames)
        self.n_ticks, self.controller = int(n_ticks), controller
        self.n_solver = cset.total_rows + cset.n_contacts + cset.n_bounds
        self._ctrl_packed = {}

    def __call__(self, q, v, action, carry):
        if cdyn._route(q) == "kernel":
            return self.kernel(q, v, action, carry)
        return self.plain(q, v, action, carry)

    def controller_fn(self, qc, vc, bc, ac):
        n_block = len(bc) - self.n_solver
        nd, nr = self.cset.n_distance, self.cset.n_rolling
        n_action = len(ac) - nd - nr
        cmd, bs2 = self.controller(qc, vc, bc[:n_block], ac[:n_action])
        return (list(cmd) + list(ac[n_action : n_action + nd]) + list(bc[n_block:])
                + list(ac[n_action + nd :]), list(bs2) + list(bc[n_block:]))

    def post_tick_fn(self, qc, vc, cc, bc):
        """End-of-tick solve: refresh the warm-start multipliers and the
        hysteresis masks of the carry."""
        _, lam, _, _, cact, bact = self.accel(qc, vc, cc)
        n_block = len(bc) - self.n_solver
        return list(bc[:n_block]) + solver_channels(lam, cact, bact)

    def plain(self, q, v, action, carry, n_ticks: Optional[int] = None,
              n_substeps: Optional[int] = None):
        n_ticks = self.n_ticks if n_ticks is None else n_ticks
        n_substeps = self.n_substeps if n_substeps is None else n_substeps
        model = self.cd.model
        batch = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1])
        qc = [q[..., i] for i in range(model.nq)]
        vc = [v[..., i] for i in range(model.nv)]
        bc = [carry[..., i] for i in range(carry.shape[-1])]
        ac = [action[..., i] for i in range(action.shape[-1])]
        cc = []
        for t in range(n_ticks):
            cc, bc2 = self.controller_fn(qc, vc, bc, ac)
            for _ in range(n_substeps):
                qc, vc, cc = self.substep(qc, vc, cc)
            if t < n_ticks - 1:
                bc2 = self.post_tick_fn(qc, vc, cc, bc2)
            bc = bc2
        extras = self.final_outputs(qc, vc, cc) + list(cc) + list(bc)
        return cdyn._stack(qc, batch, q), cdyn._stack(vc, batch, q), cdyn._stack(extras, batch, q)

    def launch_geometry(self, device, dtype) -> tuple:
        """(bytes of shared memory an env, envs a block, envs an SM) of this
        integrator's `cdyn_rollout_cm` launches on an action row of the
        controller's command width."""
        n_action = self.n_cmd + self.cset.n_distance + self.cset.n_rolling
        n_block = 3 * self.n_cmd if self.controller.kind == cdyn.CONTROLLER_PD else 0
        return self._launch_geometry("cdyn_rollout_cm", device, dtype, n_action, n_block)

    def kernel(self, q, v, action, carry, n_ticks: Optional[int] = None,
               n_substeps: Optional[int] = None):
        n_ticks = self.n_ticks if n_ticks is None else n_ticks
        n_substeps = self.n_substeps if n_substeps is None else n_substeps
        packed = self.cd.pack(self.tau_c, self.dt, self.imu_frames, q.device, q.dtype)
        key = (q.device, q.dtype)
        ctrl = self._ctrl_packed.get(key)
        if ctrl is None:
            ctrl = self._ctrl_packed[key] = self.controller.pack(q.device, q.dtype)
        n_extra = self.n_extra + self.n_cc + carry.shape[-1]
        return _launch_rollout_cm(
            packed, self.pack(q.device, q.dtype), ctrl, self.controller.kind, q, v, action,
            carry, n_ticks, n_substeps, cdyn._INTEGRATORS[self.integrator], self.n_cmd, n_extra,
        )


# --------------------------------------------------------------------------- #
# Constant packing (layout read by csrc/pgs.cuh, `struct CModel`)
# --------------------------------------------------------------------------- #

SI_HEADER, SF_HEADER = 8, 8  # [N nb nc iter_max stage_warm support_width nd nr],
#                               [kp kd friction torsion reg min_reg transition_eps ...]
SI_BOUND, SI_CONTACT = 2, 3  # (q index, v index); (parent joint, support size, support offset)
SI_DISTANCE = 4  # (parent joint a, parent joint b, support size, support offset)
SI_ROLLING = 4  # (parent joint, support size, support offset, 1 for a wheel)
SF_BOUND, SF_CONTACT, SF_DISTANCE = 4, 12, 6  # (lo hi lo+eps hi-eps); fpos(3) frot(9); fpos a, b
SF_ROLLING = 7  # fpos(3), radius, a wheel's axis in its joint's coordinates (3)


@dataclasses.dataclass(eq=False)
class PackedConstraints:
    si: torch.Tensor  # int32
    sf: torch.Tensor  # the run's float dtype
    counts: dict  # n_rows, nb, nc


def support_dofs(cd, joint: int) -> list:
    """The dofs of `joint` and its ancestors, ascending: the support of a
    contact row on a frame of `joint` (the dofs its Jacobian may touch)."""
    c = cd.c
    dofs = []
    for j in cd._ancestors(joint):
        width = 6 if c.types[j] == jt.JointType.FREE else 1
        dofs += range(c.idx_v[j], c.idx_v[j] + width)
    return sorted(dofs)


def pack_constraints(cd, cset: ConstraintSet, opts: SolverOptions, device,
                     dtype) -> PackedConstraints:
    """Pack the row layout, bound limits, contact frames, loop closures'
    frames, the contacts' radii, the rolling constraints (spheres, then
    wheels) and the support dofs (a loop's: the union of both frames'
    chains), solver constants and the relaxation weights of every sweep.
    Floats are computed in float64 on the host, as the plain version
    computes its Python-float constants, then rounded once to `dtype`. The
    ground's program travels in the model's buffers (`cdyn.pack_model`)."""
    model, c = cd.model, cd.c
    nb, nc, n, nd = cset.n_bounds, cset.n_contacts, cset.total_rows, cset.n_distance
    rolling = [(f, r, None) for f, r in cset.sphere_specs] + list(cset.wheel_specs)
    nr = len(rolling)
    lo_all = np.asarray(model.position_limit_lower, dtype=np.float64)
    hi_all = np.asarray(model.position_limit_upper, dtype=np.float64)
    eps = opts.transition_eps
    fp = c.frame_parents
    supports = [support_dofs(cd, fp[f]) for f in cset.contact_frame_indices]
    supports += [sorted(set(support_dofs(cd, fp[fa])) | set(support_dofs(cd, fp[fb])))
                 for fa, fb in cset.distance_pairs]
    supports += [support_dofs(cd, fp[f]) for f, _, _ in rolling]
    width = max([1 if nb else 0] + [len(sup) for sup in supports])
    si = [n, nb, nc, opts.iter_max, int(opts.stage_warm_start), width, nd, nr]
    sf = [opts.kp, opts.kd, opts.friction, opts.torsion, opts.regularization, _MIN_REGULARIZER,
          eps]
    sf += [0.0] * (SF_HEADER - len(sf))
    sf += [_relaxation(it, opts.iter_max) for it in range(opts.iter_max)]
    for j in cset.bound_joint_indices:
        qi = model.idx_q[j]
        lo, hi = float(lo_all[qi]), float(hi_all[qi])
        si += [qi, model.idx_v[j]]
        sf += [lo, hi, lo + eps, hi - eps]
    off = len(si) + SI_CONTACT * nc + SI_DISTANCE * nd + SI_ROLLING * nr
    for fidx, sup in zip(cset.contact_frame_indices, supports):
        si += [fp[fidx], len(sup), off]
        off += len(sup)
        sf += list(c.fpos[fidx]) + [x for row in c.frot[fidx] for x in row]
    for (fa, fb), sup in zip(cset.distance_pairs, supports[nc:]):
        si += [fp[fa], fp[fb], len(sup), off]
        off += len(sup)
        sf += list(c.fpos[fa]) + list(c.fpos[fb])
    sf += [float(r) for r in (cset.contact_radii or (0.0,) * nc)]
    for (fidx, radius, axis), sup in zip(rolling, supports[nc + nd:]):
        si += [fp[fidx], len(sup), off, int(axis is not None)]
        off += len(sup)
        axis_p = ([0.0] * 3 if axis is None else
                  (np.asarray(c.frot[fidx], np.float64) @ np.asarray(axis, np.float64)).tolist())
        sf += list(c.fpos[fidx]) + [float(radius)] + axis_p
    for sup in supports:
        si += sup
    return PackedConstraints(
        si=torch.tensor(si, dtype=torch.int32, device=device),
        sf=torch.tensor(sf, dtype=torch.float64).to(device=device, dtype=dtype),
        counts=dict(n_rows=n, nb_rows=nb, nc_rows=nc, nd_rows=nd, nr_rows=nr,
                    iter_max=opts.iter_max, support_width=width,
                    spheres=any(r > 0.0 for r in cset.contact_radii)),
    )


# --------------------------------------------------------------------------- #
# Kernel launches
# --------------------------------------------------------------------------- #

def _n_solver(cpk: PackedConstraints) -> int:
    """Width of the solver channels [lam | contact active | bound active]."""
    return cpk.counts["n_rows"] + cpk.counts["nc_rows"] + cpk.counts["nb_rows"]


def cm_ext(packed, cpk: PackedConstraints) -> int:
    """1 when a constrained launch takes the kernels' extended body: loop
    closures, rolling rows, sphere contacts (radius > 0), or spring-damper
    contacts or penalty bounds in the core."""
    k = cpk.counts
    return int(k["nd_rows"] > 0 or k["nr_rows"] > 0 or k["spheres"]
               or packed.counts["nc"] > 0 or packed.counts["nb"] > 0)


def cm_smem_per_env(packed, cpk: PackedConstraints, dtype, n_cmd: int, n_action: int = 0,
                    n_block: int = 0) -> int:
    """Bytes of dynamic shared memory one env of a constrained launch takes:
    the model-sized slice of `csrc/pgs.cuh` (`CmLayout`) for its rows and
    supports, with the launch's command width and, for `cdyn_rollout_cm`,
    its action and controller-carry widths. Any size is taken here; a
    block's share past what the card grants fails at the launch."""
    from jiminy_torch.ops import kernels

    c, k = packed.counts, cpk.counts
    elt = torch.empty((), dtype=dtype).element_size()
    return kernels.load().cm_smem_bytes(c["nj"], c["nq"], c["nv"], k["n_rows"], k["nc_rows"],
                                        k["nb_rows"], k["support_width"], k["nd_rows"], c["nc"],
                                        k["nr_rows"], n_cmd, n_action, n_block, elt)


def cm_geometry(name: str, packed, cpk: PackedConstraints, dtype, smem: int) -> tuple:
    """(envs a block, envs an SM) of a constrained launch (`name`, with
    `smem` bytes an env): the envs a block that keep the most envs resident
    an SM (`kernels.Library.cm_geometry`)."""
    from jiminy_torch.ops import kernels

    elt = torch.empty((), dtype=dtype).element_size()
    return kernels.load().cm_geometry(name, elt, smem, packed.terrain, cm_ext(packed, cpk))


def _launch_period_cm(packed, cpk: PackedConstraints, q, v, cc, n_substeps: int,
                      integrator: int, n_cmd: int, n_extra: int):
    cdyn._check_inputs(packed, q, v, cc)
    cdyn._check_inputs(packed, cpk.sf)
    nq, nv, n_cc = packed.counts["nq"], packed.counts["nv"], cc.shape[-1]
    smem = cm_smem_per_env(packed, cpk, q.dtype, n_cmd)
    if n_cc != n_cmd + cpk.counts["nd_rows"] + _n_solver(cpk) + cpk.counts["nr_rows"]:
        raise ValueError(f"cdyn_period_cm: command row width {n_cc} != {n_cmd} + loop lengths "
                         "+ solver channels + rolling heights")
    if n_cmd < packed.counts["nm"]:
        raise ValueError(f"cdyn_period_cm: command width {n_cmd} < {packed.counts['nm']} motors")
    batch = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1], cc.shape[:-1])
    qs, vs, cs = cdyn._soa(q, batch, nq), cdyn._soa(v, batch, nv), cdyn._soa(cc, batch, n_cc)
    b = qs.shape[1]
    qo = torch.empty((nq, b), dtype=q.dtype, device=q.device)
    vo = torch.empty((nv, b), dtype=q.dtype, device=q.device)
    eo = torch.empty((n_extra, b), dtype=q.dtype, device=q.device)
    if b:
        cdyn._launch("cdyn_period_cm", q.dtype, packed.ci.data_ptr(), packed.cf.data_ptr(),
                     cpk.si.data_ptr(), cpk.sf.data_ptr(), qs.data_ptr(), vs.data_ptr(),
                     cs.data_ptr(), qo.data_ptr(), vo.data_ptr(), eo.data_ptr(), b, n_cmd,
                     int(n_substeps), int(integrator), smem,
                     cm_geometry("cdyn_period_cm", packed, cpk, q.dtype, smem)[0], packed.terrain,
                     cm_ext(packed, cpk))
    return (
        qo.t().reshape(tuple(batch) + (nq,)),
        vo.t().reshape(tuple(batch) + (nv,)),
        eo.t().reshape(tuple(batch) + (n_extra,)),
    )


def _launch_rollout_cm(packed, cpk: PackedConstraints, ctrl, kind: int, q, v, action, carry,
                       n_ticks: int, n_substeps: int, integrator: int, n_cmd: int,
                       n_extra: int):
    cdyn._check_inputs(packed, q, v, action, carry)
    cdyn._check_inputs(packed, cpk.sf)
    nq, nv = packed.counts["nq"], packed.counts["nv"]
    na, n_carry = action.shape[-1], carry.shape[-1]
    n_block = n_carry - _n_solver(cpk)
    smem = cm_smem_per_env(packed, cpk, q.dtype, n_cmd, na, n_block)
    if n_block != (3 * n_cmd if kind == cdyn.CONTROLLER_PD else 0):
        raise ValueError(f"cdyn_rollout_cm: carry width {n_carry} does not fit the controller "
                         "and the solver channels")
    if n_cmd < packed.counts["nm"]:
        raise ValueError(f"cdyn_rollout_cm: command width {n_cmd} < {packed.counts['nm']} motors")
    if kind == cdyn.CONTROLLER_ZOH and na - cpk.counts["nd_rows"] - cpk.counts["nr_rows"] < n_cmd:
        raise ValueError(f"cdyn_rollout_cm: pass-through needs >= {n_cmd} action channels")
    batch = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1], action.shape[:-1],
                                   carry.shape[:-1])
    qs, vs = cdyn._soa(q, batch, nq), cdyn._soa(v, batch, nv)
    as_, bs = cdyn._soa(action, batch, na), cdyn._soa(carry, batch, n_carry)
    b = qs.shape[1]
    qo = torch.empty((nq, b), dtype=q.dtype, device=q.device)
    vo = torch.empty((nv, b), dtype=q.dtype, device=q.device)
    eo = torch.empty((n_extra, b), dtype=q.dtype, device=q.device)
    pi, pf = ctrl
    if b:
        cdyn._launch("cdyn_rollout_cm", q.dtype, packed.ci.data_ptr(), packed.cf.data_ptr(),
                     cpk.si.data_ptr(), cpk.sf.data_ptr(), pi.data_ptr(), pf.data_ptr(),
                     int(kind), qs.data_ptr(), vs.data_ptr(), as_.data_ptr(), bs.data_ptr(),
                     qo.data_ptr(), vo.data_ptr(), eo.data_ptr(), b, na, n_block, int(n_cmd),
                     int(n_ticks), int(n_substeps), int(integrator), smem,
                     cm_geometry("cdyn_rollout_cm", packed, cpk, q.dtype, smem)[0],
                     packed.terrain, cm_ext(packed, cpk))
    return (
        qo.t().reshape(tuple(batch) + (nq,)),
        vo.t().reshape(tuple(batch) + (nv,)),
        eo.t().reshape(tuple(batch) + (n_extra,)),
    )


def solver_options(options) -> SolverOptions:
    """`SolverOptions` of engine options (`EngineOptions`)."""
    omega = 2.0 * math.pi * options.contacts.stabilization_freq
    return SolverOptions(
        kp=omega * omega,
        kd=2.0 * omega,
        transition_eps=options.contacts.transition_eps,
        friction=options.contacts.friction,
        torsion=options.contacts.torsion,
        regularization=options.stepper.pgs_regularization,
        iter_max=int(options.stepper.pgs_iter_max),
        stage_warm_start=bool(options.stepper.pgs_stage_warm_start),
    )
