"""Kinematic constraint registry (port of `jiminy_tpu.engine.constraints`,
`ConstraintSet` and `build_constraint_set`).

The registry is resolved once per engine in the reference ordering
BOUNDS_JOINTS -> CONTACT_FRAMES -> distance loops -> rolling rows; the PGS
solution depends on this order. Row conventions:

- joint bound (1 row): J = +-e_vidx, lambda in [0, inf);
- contact frame (4 rows [tx, ty, tz, rz] in the ground-normal basis): the
  normal row lambda_z >= 0, the torsion row |lambda_rz| <= torsion
  lambda_z, the tangent rows ||lambda_xy|| <= mu lambda_z;
- distance (1 row) and rolling (3 rows per sphere or wheel): unbounded.

The component solver (`engine/solver.py`) assembles bound and contact rows;
distance and rolling rows are ROADMAP.md queue 1 item 10.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from jiminy_torch.models import joints as jt


@dataclasses.dataclass(frozen=True)
class ConstraintSet:
    """Static constraint registry (reference `ConstraintTree`)."""

    # Joint bounds: one row per bounded 1-dof joint (mechanical joints with motors)
    bound_joint_indices: tuple = ()
    # Ground contacts: frame indices (robot.contact_frame_indices order)
    contact_frame_indices: tuple = ()
    # Per-contact sphere radius, 0.0 = point
    contact_radii: tuple = ()
    # Closed loops: ((frame_a, frame_b), ...)
    distance_pairs: tuple = ()
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
        sphere_specs=tuple(spheres),
        wheel_specs=tuple(wheels),
    )
