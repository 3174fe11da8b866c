"""Kinematic constraints (port of `jiminy_tpu.engine.constraints`): the
static registry (`ConstraintSet`, `build_constraint_set`) and the generic
path's batched assembly of the rows (`ConstraintSystem`,
`compute_constraint_system`).

The registry is resolved once per engine in the reference ordering
BOUNDS_JOINTS -> CONTACT_FRAMES -> distance loops -> rolling rows; the PGS
solution depends on this order. Row conventions:

- joint bound (1 row): J = +-e_vidx, lambda in [0, inf);
- contact frame (4 rows [tx, ty, tz, rz] in the ground-normal basis): the
  normal row lambda_z >= 0, the torsion row |lambda_rz| <= torsion
  lambda_z, the tangent rows ||lambda_xy|| <= mu lambda_z;
- distance (1 row) and rolling (3 rows per sphere or wheel): unbounded.

The component solver (`engine/solver.py`) and `compute_constraint_system`
assemble bound, contact and distance rows; rolling rows are ROADMAP.md
queue 1 item 10.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from jiminy_torch.engine.config import ContactOptions
from jiminy_torch.engine.contact import flat_ground
from jiminy_torch.models import joints as jt
from jiminy_torch.models.model import RobotModel
from jiminy_torch.ops import lie
from jiminy_torch.ops.kinematics import (
    KinData,
    frame_jacobian_world_aligned,
    frame_placement,
    frame_velocity_local,
)


@dataclasses.dataclass(frozen=True)
class ConstraintSet:
    """Static constraint registry (reference `ConstraintTree`)."""

    # Joint bounds: one row per bounded 1-dof joint (mechanical joints with motors)
    bound_joint_indices: tuple = ()
    # Ground contacts: frame indices (robot.contact_frame_indices order)
    contact_frame_indices: tuple = ()
    # Per-contact sphere radius, 0.0 = point
    contact_radii: tuple = ()
    # Closed loops: ((frame_a, frame_b), ...) and their lengths (zeros here:
    # the engine computes them at the reset pose, `compute_distance_refs`)
    distance_pairs: tuple = ()
    distance_ref: tuple = ()
    # Rolling without slip: spheres ((frame, radius), ...) and wheels
    # ((frame, radius, (ax, ay, az)), ...), 3 unbounded rows each
    sphere_specs: tuple = ()
    wheel_specs: tuple = ()

    @property
    def n_bounds(self) -> int:
        return len(self.bound_joint_indices)

    @property
    def n_contacts(self) -> int:
        return len(self.contact_frame_indices)

    @property
    def n_distance(self) -> int:
        return len(self.distance_pairs)

    @property
    def n_rolling(self) -> int:
        return len(self.sphere_specs) + len(self.wheel_specs)

    @property
    def total_rows(self) -> int:
        return self.n_bounds + 4 * self.n_contacts + self.n_distance + 3 * self.n_rolling

    def row_offsets(self):
        """(bounds_start, contacts_start, distance_start, rolling_start)."""
        off_d = self.n_bounds + 4 * self.n_contacts
        return 0, self.n_bounds, off_d, off_d + self.n_distance


def build_constraint_set(robot, loop_pairs=(), include_contacts=True,
                         include_bounds=True) -> ConstraintSet:
    """The registry of a robot: bounds for motorized 1-dof joints with finite
    limits, contacts for every contact frame (constraint contact mode only),
    plus explicit loop closures and rolling specs."""
    model = robot.model
    bounds = []
    if include_bounds:
        lo = np.asarray(model.position_limit_lower)
        hi = np.asarray(model.position_limit_upper)
        candidates = list(robot.motors.joint_indices) if robot.motors else []
        candidates += list(getattr(robot, "backlash_joint_indices", ()))
        for j in candidates:
            t = jt.JointType(model.joint_types[j])
            if t in (jt.JointType.REVOLUTE, jt.JointType.PRISMATIC):
                qi = model.idx_q[j]
                if np.isfinite(lo[qi]) or np.isfinite(hi[qi]):
                    bounds.append(j)
    pairs = tuple(
        (model.frame_index(a) if isinstance(a, str) else a,
         model.frame_index(b) if isinstance(b, str) else b)
        for a, b in loop_pairs
    )
    spheres, wheels = [], []
    for name, radius, axis in getattr(robot, "rolling_specs", ()):
        fidx = model.frame_index(name) if isinstance(name, str) else name
        if axis is None:
            spheres.append((fidx, radius))
        else:
            wheels.append((fidx, radius, tuple(axis)))
    return ConstraintSet(
        bound_joint_indices=tuple(bounds),
        contact_frame_indices=tuple(robot.contact_frame_indices) if include_contacts else (),
        contact_radii=(
            tuple(robot.contact_radii or (0.0,) * len(robot.contact_frame_indices))
            if include_contacts
            else ()
        ),
        distance_pairs=pairs,
        distance_ref=(0.0,) * len(pairs),
        sphere_specs=tuple(spheres),
        wheel_specs=tuple(wheels),
    )


def compute_distance_refs(model: RobotModel, cset: ConstraintSet, kin: KinData) -> torch.Tensor:
    """The loop closures' lengths at a configuration: (..., nd)."""
    refs = [
        torch.linalg.norm(frame_placement(model, kin, fa)[1] - frame_placement(model, kin, fb)[1],
                          dim=-1)
        for fa, fb in cset.distance_pairs
    ]
    if refs:
        return torch.stack(refs, dim=-1)
    return kin.vel.new_zeros(kin.vel.shape[:-2] + (0,))


class ConstraintSystem(NamedTuple):
    """One evaluation's assembled constraint problem."""

    jac: torch.Tensor  # (..., N, nv)
    drift: torch.Tensor  # (..., N)
    active: torch.Tensor  # (..., N) bool row activity
    contact_basis: torch.Tensor  # (..., nc, 3, 3) ground-normal basis (world columns)
    contact_active: torch.Tensor  # (..., nc)
    bound_active: torch.Tensor  # (..., nb)
    contact_depth: torch.Tensor  # (..., nc)


def _normal_basis(n: torch.Tensor) -> torch.Tensor:
    """Right-handed basis whose column 2 is the ground normal (reference
    `FrameConstraint::setNormal`)."""
    ex = torch.zeros_like(n)
    ex[..., 0] = 1.0
    c1 = lie.cross(n, ex)
    # Degenerate when n ~ ex: n x ey instead
    ey = torch.zeros_like(n)
    ey[..., 1] = 1.0
    c1_alt = lie.cross(n, ey)
    use_alt = torch.linalg.norm(c1, dim=-1, keepdim=True) < 1e-6
    c1 = torch.where(use_alt, c1_alt, c1)
    c1 = c1 / torch.clamp(torch.linalg.norm(c1, dim=-1, keepdim=True), min=1e-12)
    c0 = lie.cross(c1, n)
    return torch.stack([c0, c1, n], dim=-1)


def compute_constraint_system(model: RobotModel, cset: ConstraintSet, opts: ContactOptions,
                              ground_fn: Optional[Callable], kin_bias: KinData,
                              jac_world: torch.Tensor, q: torch.Tensor, v: torch.Tensor,
                              prev_contact_active: torch.Tensor,
                              prev_bound_active: torch.Tensor,
                              distance_ref: Optional[torch.Tensor] = None) -> ConstraintSystem:
    """(J, drift, active) of the bound, contact and distance rows, with the
    reference's hysteresis on the active sets. `kin_bias` is forward
    kinematics at zero acceleration, so its accelerations are the
    velocity-bias terms; `distance_ref` (..., nd) the loops' lengths (None:
    the set's own)."""
    if cset.n_rolling:
        raise NotImplementedError(
            "rolling constraint rows are not ported yet (ROADMAP.md queue 1 item 10)"
        )
    if ground_fn is None:
        ground_fn = flat_ground
    batch = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1])
    nv = model.nv
    n_rows = cset.total_rows
    jac = q.new_zeros(batch + (n_rows, nv))
    drift = q.new_zeros(batch + (n_rows,))
    active = torch.zeros(batch + (n_rows,), dtype=torch.bool, device=q.device)

    omega = 2.0 * math.pi * opts.stabilization_freq
    kp, kd = omega * omega, 2.0 * omega
    off_b, off_c, off_d, _ = cset.row_offsets()
    lo_all = np.asarray(model.position_limit_lower, np.float64)
    hi_all = np.asarray(model.position_limit_upper, np.float64)

    # Joint bounds: blocked in one direction, J = -e above the upper bound
    # and +e otherwise, lambda >= 0
    bound_active_list = []
    for k, j in enumerate(cset.bound_joint_indices):
        qi, vi = model.idx_q[j], model.idx_v[j]
        qj, vj = q[..., qi], v[..., vi]
        lo, hi = float(lo_all[qi]), float(hi_all[qi])
        over = qj > hi
        raw = over | (qj < lo)
        inside = (qj > lo + opts.transition_eps) & (qj < hi - opts.transition_eps)
        act = raw | (prev_bound_active[..., k] & ~inside)
        bound_active_list.append(act)
        sign = torch.where(over, -1.0, 1.0).to(q.dtype)
        row = off_b + k
        jac[..., row, vi] = sign
        dq = qj - torch.clamp(qj, lo, hi)
        drift[..., row] = sign * (kp * dq + kd * vj)
        active[..., row] = act
    bound_active = (torch.stack(bound_active_list, dim=-1) if bound_active_list
                    else torch.zeros(batch + (0,), dtype=torch.bool, device=q.device))

    # Contact frames
    basis_list, cact_list, depth_list = [], [], []
    radii = cset.contact_radii or (0.0,) * cset.n_contacts
    fplace_rot = model.tensor("fplacement_rot", q.device, q.dtype)
    fplace_pos = model.tensor("fplacement_pos", q.device, q.dtype)
    for k, fidx in enumerate(cset.contact_frame_indices):
        radius = radii[k]
        rot, pos = frame_placement(model, kin_bias, fidx)
        h, n = ground_fn(pos[..., :2])
        n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
        depth = (pos[..., 2] - h) * n[..., 2]
        if radius > 0.0:
            depth = depth - radius
        act = (depth < 0.0) | (prev_contact_active[..., k] & (depth <= opts.transition_eps))
        basis = _normal_basis(n)

        # The frame Jacobian, world-aligned (ang, lin), in basis coordinates
        jf = frame_jacobian_world_aligned(model, kin_bias, jac_world, fidx)
        bt = basis.transpose(-1, -2)
        j_lin_w = jf[..., 3:6, :]
        if radius > 0.0:
            # A sphere: the surface point at -r n
            sk = radius * lie.skew(n)
            j_lin_w = j_lin_w + lie.mm(sk, jf[..., 0:3, :])
        j_lin = lie.mm(bt, j_lin_w)
        j_ang = lie.mm(bt, jf[..., 0:3, :])

        # The frame's classical world-aligned bias acceleration and velocity
        v_local = frame_velocity_local(model, kin_bias, fidx)
        parent = model.frame_parents[fidx]
        a_sp_local = lie.motion_act_inv(fplace_rot[fidx], fplace_pos[fidx],
                                        kin_bias.acc[..., parent, :])
        v_ang_w = lie.mv(rot, v_local[..., 0:3])
        v_lin_w = lie.mv(rot, v_local[..., 3:6])
        a_lin_w = lie.mv(rot, a_sp_local[..., 3:6]) + lie.cross(v_ang_w, v_lin_w)
        a_ang_w = lie.mv(rot, a_sp_local[..., 0:3])
        if radius > 0.0:
            v_lin_w = v_lin_w + lie.mv(sk, v_ang_w)
            a_lin_w = a_lin_w + lie.mv(sk, a_ang_w)

        # Baumgarte: the reference sits on the ground below the frame, so
        # the position error is depth n and the rotation error 0
        g_lin = a_lin_w + kp * depth[..., None] * n + kd * v_lin_w
        g_ang = a_ang_w + kd * v_ang_w
        g_lin_b = lie.mv(bt, g_lin)
        g_ang_b = lie.mv(bt, g_ang)

        row = off_c + 4 * k
        jac[..., row : row + 3, :] = j_lin
        jac[..., row + 3, :] = j_ang[..., 2, :]
        drift[..., row : row + 3] = g_lin_b
        drift[..., row + 3] = g_ang_b[..., 2]
        active[..., row : row + 4] = act[..., None]
        basis_list.append(basis)
        cact_list.append(act)
        depth_list.append(depth)

    contact_basis = (torch.stack(basis_list, dim=-3) if basis_list
                     else q.new_zeros(batch + (0, 3, 3)))
    contact_active = (torch.stack(cact_list, dim=-1) if cact_list
                      else torch.zeros(batch + (0,), dtype=torch.bool, device=q.device))
    contact_depth = (torch.stack(depth_list, dim=-1) if depth_list
                     else q.new_zeros(batch + (0,)))

    # Distance loops: the frames' relative velocity and bias acceleration
    # along their direction, unbounded and always active
    def frame_lin(fidx):
        rot, pos = frame_placement(model, kin_bias, fidx)
        v_local = frame_velocity_local(model, kin_bias, fidx)
        parent = model.frame_parents[fidx]
        a_sp = lie.motion_act_inv(fplace_rot[fidx], fplace_pos[fidx],
                                  kin_bias.acc[..., parent, :])
        v_ang_w = lie.mv(rot, v_local[..., 0:3])
        v_lin_w = lie.mv(rot, v_local[..., 3:6])
        a_lin_w = lie.mv(rot, a_sp[..., 3:6]) + lie.cross(v_ang_w, v_lin_w)
        jf = frame_jacobian_world_aligned(model, kin_bias, jac_world, fidx)
        return pos, v_lin_w, a_lin_w, jf[..., 3:6, :]

    for k, (fa, fb) in enumerate(cset.distance_pairs):
        pa, va, aa, ja = frame_lin(fa)
        pb, vb, ab, jb = frame_lin(fb)
        dp = pa - pb
        dist = torch.clamp(torch.linalg.norm(dp, dim=-1), min=1e-12)
        direction = dp / dist[..., None]
        dv = va - vb
        dv_proj = (dv * direction).sum(-1)
        g = (direction * (aa - ab)).sum(-1)
        g = g + ((dv * dv).sum(-1) - dv_proj**2) / dist
        ref = (q.new_tensor(cset.distance_ref) if distance_ref is None else distance_ref)[..., k]
        g = g + kp * (dist - ref) + kd * dv_proj
        row = off_d + k
        jac[..., row, :] = lie.mv((ja - jb).transpose(-1, -2), direction)
        drift[..., row] = g
        active[..., row] = True
    return ConstraintSystem(jac=jac, drift=drift, active=active, contact_basis=contact_basis,
                            contact_active=contact_active, bound_active=bound_active,
                            contact_depth=contact_depth)
