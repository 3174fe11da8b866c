"""The simulation engine (port of `jiminy_tpu.engine.engine`): the component
core (spring-damper contacts, or PGS joint bounds and ground contacts with
`ContactModel.CONSTRAINT`, `joint_bounds_mode="constraint"`, and PGS loop
closures beside spring-damper contacts and penalty bounds), and the generic
dynamics path.

- `Engine.reset(q0, v0)` builds the initial state; its dynamics evaluation
  goes through `cdyn_accel` on the card (spring-damper core), the plain
  constrained solve (constrained core; plain torch on the card, as
  jiminy_tpu runs it in XLA outside its kernels), or `dynamics_full`
  (generic path).
- `Engine.step(state, command)` advances one controller period with a
  zero-order-held command: through `cdyn_period` or `cdyn_period_cm` on the
  core (Euler, RK4), under adaptive DOPRI 5(4) through trials of six
  dynamics evaluations each in masked lock-step over the batch
  (`engine/steppers.py`), and on the generic path stage by stage, every
  stage one `dynamics_full`. A robot with flexibility joints (SPHERICAL
  joints) steps stage by stage on the core, every stage one `cdyn_accel`,
  as jiminy_tpu turns its fused period and rollout off for it; on the card
  its tick replays from a CUDA graph.
- `Engine.step_rollout_fused(...)` advances a whole env step, the controller
  re-evaluated at every period, through `cdyn_rollout` or `cdyn_rollout_cm`
  (the core only).

The path follows jiminy_tpu's rule, on every device: the component core when
`cdyn.supports_model` holds (a free-flyer or fixed root with revolute,
prismatic and spherical joints), no external force is registered, the
robot has no collision pair and `use_fast_dynamics` is not False (with PGS
rows, a model without spherical joints: the constrained kernels take 1-dof
joints only); otherwise the
generic path (`dynamics_full`: generic forward
kinematics, spring-damper contact forces, penalty bounds, then ABA or the
array-form PGS solve), plain torch on every device, as jiminy_tpu runs it in
XLA. Unlike jiminy_tpu, which takes its component core only off the CPU, the
port takes it on the CPU too (its plain version there), so the CPU tests
exercise the card's control flow. The world's ground profile
(`utils.terrain`) reaches every path: the kernels evaluate its packed form
per contact; one without a packed form runs on the CPU only
(`terrain.ground_route`). Options whose code paths are not ported raise
`NotImplementedError` naming the ROADMAP.md item that will port them.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from jiminy_torch import pytree
from jiminy_torch.devices import resolve_device, resolve_dtype
from jiminy_torch.engine import solver, steppers
from jiminy_torch.engine.config import ContactModel, EngineOptions, IntegratorType
from jiminy_torch.engine.constraints import (
    build_constraint_set,
    compute_constraint_system,
    compute_distance_refs,
)
from jiminy_torch.engine.contact import compute_contact_forces, compute_pair_forces
from jiminy_torch.engine.hardware import ImuSensorGroup
from jiminy_torch.engine.internal import flexibility_torque
from jiminy_torch.engine.robot import Robot
from jiminy_torch.engine.state import SimState, StepperState
from jiminy_torch.models import joints as jt
from jiminy_torch.ops import cdyn
from jiminy_torch.ops import dynamics as dyn
from jiminy_torch.ops import integrate as integ
from jiminy_torch.ops import lie
from jiminy_torch.ops.kinematics import forward_kinematics, frame_placement, joint_space_jacobian
from jiminy_torch.utils import terrain

_FIXED_STEP = {
    IntegratorType.EULER_EXPLICIT: "euler",
    IntegratorType.RUNGE_KUTTA_4: "rk4",
}
_PGS_KEYS = ("lam", "contact_active", "bound_active")  # what the solve's stages refresh
_REF_KEYS = ("distance_ref", "rolling_ref")  # constant through a step


def _refuse_unported(robot: Robot, opts: EngineOptions, device: torch.device) -> None:
    # A ground profile runs on every path; off the CPU only through its
    # packed form, which the kernels evaluate
    terrain.ground_route(opts.world.ground_profile, device)
    if opts.joint_bounds_mode not in ("constraint", "penalty", "none"):
        raise ValueError(f"unknown joint_bounds_mode {opts.joint_bounds_mode!r}")
    for name, g in robot.sensors.groups():
        if not g.is_clean():
            raise NotImplementedError(
                f"sensor group '{name}' declares noise, bias or delay, which is not "
                "ported yet (ROADMAP.md queue 1 item 11)"
            )


def penalty_bounds_torque(gains: dict, nv: int, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Penalty joint-bound torques with per-dof gains {vidx: (lo, hi, kp, kd,
    qidx)}, the formula of the component core's penalty bounds."""
    u = q.new_zeros(torch.broadcast_shapes(q.shape[:-1], v.shape[:-1]) + (nv,))
    for vi, (lo, hi, kp, kd, qi) in gains.items():
        qj, vj = q[..., qi], v[..., vi]
        over = torch.clamp(qj - hi, min=0.0)
        under = torch.clamp(lo - qj, min=0.0)
        active = (over > 0.0) | (under > 0.0)
        u[..., vi] = u[..., vi] + (kp * (under - over) - torch.where(active, kd * vj, 0.0))
    return u


class Engine:
    """Single-robot engine holding the static configuration."""

    def __init__(self, robot: Robot, options: Optional[EngineOptions] = None,
                 device=None, dtype=None):
        self.robot = robot
        self.options = opts = options or EngineOptions()
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        _refuse_unported(robot, opts, self.device)
        self.ground_fn = opts.world.ground_profile
        self.sensor_period = opts.sensor_update_period or opts.controller_update_period
        self.control_period = opts.controller_update_period or self.sensor_period
        if self.control_period <= 0:
            raise ValueError("controller_update_period must be > 0")
        ratio = self.control_period / self.sensor_period
        if ratio < 1.0 - 1e-9:
            raise NotImplementedError(
                "sensor periods longer than the controller period are not ported yet "
                "(ROADMAP.md queue 1 item 11)"
            )
        self.n_sensor_periods = max(int(round(ratio)), 1)
        if abs(ratio - self.n_sensor_periods) > 1e-9:
            raise ValueError("controller period must be a multiple of the sensor period")
        self.tick_period = self.sensor_period
        self.n_substeps = max(int(math.ceil(self.tick_period / opts.stepper.dt_max - 1e-12)), 1)
        self.gravity = torch.tensor(opts.world.gravity, dtype=self.dtype, device=self.device)

        self._imu_group_frames = [
            (name, tuple(g.frame_indices))
            for name, g in robot.sensors.groups()
            if isinstance(g, ImuSensorGroup)
        ]
        self._imu_frames = tuple(f for _, frames in self._imu_group_frames for f in frames)
        self._bound_gains = (
            self._build_penalty_bound_gains() if opts.joint_bounds_mode == "penalty" else {}
        )
        # In constraint contact mode the contacts, and with "constraint"
        # bounds the joint bounds, are PGS rows
        self.constraint_mode = opts.contacts.model == ContactModel.CONSTRAINT
        self.cset = build_constraint_set(
            robot,
            loop_pairs=robot.loop_pairs,
            include_contacts=self.constraint_mode,
            include_bounds=opts.joint_bounds_mode == "constraint",
        )
        self.has_constraints = self.cset.total_rows > 0
        self._has_joint_damping = bool(np.any(np.asarray(robot.model.damping) != 0.0))
        # User forces f(t, q, v) -> (..., nj, 6) LOCAL joint wrenches; while
        # any is registered, the generic path runs
        self.external_force_fn: Optional[Callable] = None
        self._registered_forces: list = []
        if self.has_constraints:
            if opts.stepper.integrator not in _FIXED_STEP:
                raise NotImplementedError(
                    "adaptive DOPRI beside PGS rows (constraint contacts or bounds) is not "
                    "ported yet: its stage-warm-started trial, jiminy_tpu's "
                    "dopri_trial_stateful (ROADMAP.md queue 1 item 11)"
                )
        # (constraint contact mode with no row solves an empty system on the
        # generic path)
        self._solver_opts = solver.solver_options(opts)
        gravity = tuple(float(g) for g in opts.world.gravity)
        self._cdyn = self._cdyn_cm = None
        # Collision pairs run on the generic path in both contact modes, as
        # jiminy_tpu turns its fused paths off for them
        self._has_pairs = bool(robot.collision_pairs_geom)
        core = (opts.use_fast_dynamics is not False and not self._has_pairs
                and cdyn.supports_model(robot.model))
        spherical = cdyn.has_spherical(robot.model)
        if core and self.has_constraints and not spherical:
            # Component CRBA/NLE for the PGS path; out of constraint contact
            # mode with the spring-damper contacts and the penalty bounds
            # beside the rows (jiminy_tpu hands its integrators no bound
            # gains in constraint contact mode)
            spring = not self.constraint_mode
            self._cdyn_cm = cdyn.ComponentDynamics(
                robot.model,
                gravity,
                contact_opts=opts.contacts if spring else None,
                contact_frames=robot.contact_frame_indices if spring else (),
                contact_radii=robot.contact_radii if spring else (),
                bound_gains=self._bound_gains if spring else {},
                ground_fn=self.ground_fn,
            )
        elif core and not self.has_constraints and not self.constraint_mode:
            self._cdyn = cdyn.ComponentDynamics(
                robot.model,
                gravity,
                contact_opts=opts.contacts,
                contact_frames=robot.contact_frame_indices,
                contact_radii=robot.contact_radii,
                bound_gains=self._bound_gains,
                ground_fn=self.ground_fn,
            )
        # (constraint contact mode with no row builds no core, as in
        # jiminy_tpu; PGS rows beside SPHERICAL joints take the generic path,
        # as jiminy_tpu runs them in XLA outside its kernels.) SPHERICAL
        # joints (flexibility) turn the fused period and rollout off: the
        # core steps stage by stage, every stage one cdyn_accel
        self._stagewise = self._cdyn is not None and spherical
        self._tau_c = self._build_tau_c()
        self._period_runs = {}
        # The generic path's substep, and its ticks' CUDA graphs by input shape
        self._dt_tick = torch.as_tensor(self.tick_period, dtype=self.dtype,
                                        device=self.device) / self.n_substeps
        self._graphs = {}

    def _build_penalty_bound_gains(self) -> dict:
        """Per-joint penalty gains kp = m_ii w^2, kd = 2 m_ii w, with m_ii the
        apparent joint inertia at the neutral pose."""
        model = self.robot.model
        candidates = list(self.robot.motors.joint_indices) if self.robot.motors else []
        candidates += list(self.robot.backlash_joint_indices)
        if not candidates:
            return {}
        q0 = torch.as_tensor(model.neutral(), dtype=torch.float64)
        m_diag = torch.diagonal(dyn.crba(model, q0)).numpy()
        omega = 2.0 * math.pi * self.options.joint_bounds_freq
        gains = {}
        for j in candidates:
            if jt.JointType(model.joint_types[j]) not in (
                jt.JointType.REVOLUTE, jt.JointType.PRISMATIC
            ):
                continue
            qi, vi = model.idx_q[j], model.idx_v[j]
            lo = float(model.position_limit_lower[qi])
            hi = float(model.position_limit_upper[qi])
            if not (np.isfinite(lo) or np.isfinite(hi)):
                continue
            m = max(float(m_diag[vi]), 1e-6)
            gains[vi] = (lo, hi, m * omega**2, 2.0 * m * omega, qi)
        return gains

    def _build_tau_c(self) -> cdyn.MotorTransmission:
        """Component-wise motor transmission with per-motor constants (the
        plain callable and the kernel's packed constants)."""
        motors = self.robot.motors
        if motors is None or not motors.nmotors:
            return cdyn.MotorTransmission(self.robot.nv, *([()] * 12))
        return cdyn.MotorTransmission.from_motor_bank(motors, self.robot.nv)

    def _zeros(self, shape, dtype=None):
        return torch.zeros(shape, dtype=dtype or self.dtype, device=self.device)

    def _compute_efforts(self, command, v):
        motors = self.robot.motors
        if motors is None or not motors.nmotors:
            return self._zeros(v.shape[:-1] + (0,)), torch.zeros_like(v)
        return motors.compute_efforts(command, v)

    def _joint_torques(self, command, q, v):
        """(u_motor, u): the motor efforts under `command` and the joint
        torques, the motors' plus the flexibility joints' spring-dampers
        (`internal.flexibility_torque`), on every path."""
        u_motor, u = self._compute_efforts(command, v)
        if self.robot.has_flexibility:
            u = u + flexibility_torque(self.robot, q, v)
        return u_motor, u

    # ------------------------------------------------------------------ #
    def _get_period_run(self, kind: str):
        run = self._period_runs.get(kind)
        if run is None:
            dt = self.tick_period / self.n_substeps
            if self._cdyn_cm is not None:
                run = solver.ConstrainedPeriodIntegrator(
                    self._cdyn_cm, self._tau_c, self.cset, self._solver_opts, dt,
                    self.n_substeps, kind, self.robot.nmotors, self._imu_frames,
                )
            else:
                run = self._cdyn.make_period_integrator(
                    self._tau_c, dt, self.n_substeps, integrator=kind,
                    imu_frames=self._imu_frames,
                )
            self._period_runs[kind] = run
        return run

    def _solver_widths(self):
        """(N, nc, nb): the multiplier and active-set widths of the
        constrained path's extras and carry (zero on the spring path)."""
        if self._cdyn_cm is None:
            return 0, 0, 0
        return self.cset.total_rows, self.cset.n_contacts, self.cset.n_bounds

    def _unpack_period_extras(self, extras, command, v, n_lam: int = 0, n_cact: int = 0,
                              n_bact: int = 0):
        """Split `[a | f_world | w_local | depth | imu | lam | cact | bact]`
        into (a, aux)."""
        robot = self.robot
        nv = robot.nv
        nc = len(robot.contact_frame_indices)
        batch = extras.shape[:-1]
        a = extras[..., :nv]
        off = nv
        fw = extras[..., off : off + 3 * nc].reshape(batch + (nc, 3))
        off += 3 * nc
        wl = extras[..., off : off + 6 * nc].reshape(batch + (nc, 6))
        off += 6 * nc
        depth = extras[..., off : off + nc]
        off += nc
        raws = {}
        for name, frames in self._imu_group_frames:
            k = len(frames)
            raws[name] = extras[..., off : off + 6 * k].reshape(batch + (k, 6))
            off += 6 * k
        u_motor, _ = self._compute_efforts(command, v)
        aux = {
            "u_motor": u_motor,
            "contact_f_world": fw,
            "contact_w_local": wl,
            "contact_depth": depth,
            "sensor_raws": raws,
        }
        if n_lam:
            aux["lam"] = extras[..., off : off + n_lam]
            aux["contact_active"] = extras[..., off + n_lam : off + n_lam + n_cact] > 0.5
            aux["bound_active"] = extras[..., off + n_lam + n_cact : off + n_lam + n_cact + n_bact] > 0.5
        return a, aux

    def _use_core(self) -> bool:
        """True when this evaluation goes through the component core (its
        kernels on the card); False on the generic path."""
        return (self._cdyn is not None or self._cdyn_cm is not None) and (
            self.external_force_fn is None
        )

    def _final_eval(self, t, q, v, command, carry=None):
        """(a, aux) at a state. On the core: `cdyn_accel` then the plain aux
        outputs, or on the constrained core the plain constrained solve from
        a cold start (no warm start, no active set), as at jiminy_tpu's
        reset. On the generic path: `dynamics_full` from `carry`."""
        if not self._use_core():
            return self.dynamics_full(t, q, v, command, carry)
        u_motor, u = self._joint_torques(command, q, v)
        if self._cdyn_cm is not None:
            if carry is None:
                carry = self._zero_carry(torch.broadcast_shapes(q.shape[:-1], v.shape[:-1]))
            return self._constrained_eval(q, v, u, u_motor, carry["distance_ref"],
                                          carry["rolling_ref"])
        a = self._cdyn.accel(q, v, u)
        auxc = self._cdyn.aux_outputs(q, v, a, imu_frames=self._imu_frames)
        imu_raw = auxc.pop("imu_raw")
        raws = {}
        off = 0
        for name, frames in self._imu_group_frames:
            raws[name] = imu_raw[..., off : off + len(frames), :]
            off += len(frames)
        return a, {"u_motor": u_motor, "sensor_raws": raws, **auxc}

    # ------------------------------------------------------------------ #
    # External forces (reference `registerProfileForce` and
    # `registerImpulseForce`): wrenches at a frame in world-aligned axes,
    # moved onto the frame's parent joint. They run on the generic path.
    # ------------------------------------------------------------------ #
    def register_profile_force(self, frame_name: str, force_fn: Callable) -> None:
        """`force_fn(t) -> (..., 6)` world-aligned wrench (ang, lin) at the frame."""
        fidx = self.robot.model.frame_index(frame_name)
        self._registered_forces.append(("profile", fidx, force_fn))
        self._rebuild_force_fn()

    def register_impulse_force(self, frame_name: str, t_start: float, duration: float,
                               wrench) -> None:
        """A constant world wrench during [t_start, t_start + duration)."""
        fidx = self.robot.model.frame_index(frame_name)
        w = torch.as_tensor(wrench, dtype=self.dtype, device=self.device)

        def force_fn(t):
            on = (t >= t_start) & (t < t_start + duration)
            return torch.where(on, 1.0, 0.0).to(w.dtype)[..., None] * w

        self._registered_forces.append(("impulse", fidx, force_fn))
        self._rebuild_force_fn()

    def register_state_force(self, force_fn: Callable) -> None:
        """`force_fn(t, q, v, kin) -> (..., nj, 6)` LOCAL joint wrenches."""
        self._registered_forces.append(("state", None, force_fn))
        self._rebuild_force_fn()

    def remove_forces(self) -> None:
        self._registered_forces = []
        self.external_force_fn = None

    def _rebuild_force_fn(self) -> None:
        model = self.robot.model
        entries = list(self._registered_forces)

        def fn(t, q, v):
            kin = forward_kinematics(model, q, v)
            fext = q.new_zeros(q.shape[:-1] + (model.njoints, 6))
            for kind, fidx, force_fn in entries:
                if kind == "state":
                    fext = fext + force_fn(t, q, v, kin)
                    continue
                w = force_fn(t)
                parent = model.frame_parents[fidx]
                pos_f = frame_placement(model, kin, fidx)[1]
                rot_j = kin.rot[..., parent, :, :]
                pos_j = kin.pos[..., parent, :]
                lever = pos_f - pos_j
                f_w = w[..., 3:6]
                n_w = w[..., 0:3] + lie.cross(lever, f_w)
                rt = rot_j.transpose(-1, -2)
                fext[..., parent, 0:3] += lie.mv(rt, n_w)
                fext[..., parent, 3:6] += lie.mv(rt, f_w)
            return fext

        self.external_force_fn = fn if entries else None

    # ------------------------------------------------------------------ #
    # The generic path
    # ------------------------------------------------------------------ #
    def _zero_carry(self, batch, distance_ref=None, rolling_ref=None) -> dict:
        """A cold PGS carry: no multiplier, no active row; the loops' lengths
        `distance_ref` (the set's own if None) and the rolling frames'
        reference heights `rolling_ref` (None: their current heights)."""
        cset = self.cset
        if distance_ref is None:
            distance_ref = torch.as_tensor(cset.distance_ref, dtype=self.dtype,
                                           device=self.device).expand(batch + (cset.n_distance,))
        if rolling_ref is None and not cset.n_rolling:
            rolling_ref = self._zeros(batch + (0,))
        return {"lam": self._zeros(batch + (cset.total_rows,)),
                "contact_active": self._zeros(batch + (cset.n_contacts,), torch.bool),
                "bound_active": self._zeros(batch + (cset.n_bounds,), torch.bool),
                "distance_ref": distance_ref, "rolling_ref": rolling_ref}

    def _carry_of(self, state: SimState) -> dict:
        """The PGS warm start, active sets, loop lengths and rolling heights
        a state carries (a cold, zero-width carry on a state without rows)."""
        if state.lam is None:
            return self._zero_carry(state.q.shape[:-1])
        return {"lam": state.lam, "contact_active": state.contact_active,
                "bound_active": state.bound_active, "distance_ref": state.distance_ref,
                "rolling_ref": state.rolling_ref}

    def dynamics_full(self, t, q, v, command, carry=None):
        """One generic dynamics evaluation (reference
        `Engine::computeRobotsDynamics`), plain torch on every device: forward
        kinematics at zero acceleration, the spring-damper contact forces,
        the external forces and the collision pairs' forces, penalty bounds,
        then ABA, or the array-form PGS solve over the constraint rows
        (warm-started and hysteresis-masked from `carry`; None: all
        inactive). Returns (a, aux); with collision pairs aux holds
        `pair_f_world` (..., np, 3) and `pair_depth` (..., np)."""
        robot = self.robot
        model = robot.model
        batch = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1])
        nc = len(robot.contact_frame_indices)
        kin = None
        if nc or self.has_constraints or self.constraint_mode or self._has_pairs:
            # The accelerations of FK at zero acceleration are the
            # velocity-bias terms of the constraint drifts
            kin = forward_kinematics(model, q, v, q.new_zeros(batch + (model.nv,)))
        fext_user = self.external_force_fn(t, q, v) if self.external_force_fn is not None else None
        aux_pairs = {}
        if self._has_pairs:
            # Body-to-body spring-damper forces in both contact modes, as
            # joint wrenches beside the external forces
            fext_pairs, pair_f, pair_depth = compute_pair_forces(
                model, self.options.contacts, kin, robot.collision_pairs_geom)
            fext_user = fext_pairs if fext_user is None else fext_user + fext_pairs
            aux_pairs = {"pair_f_world": pair_f, "pair_depth": pair_depth}
        u_motor, u = self._joint_torques(command, q, v)
        if self._has_joint_damping:
            u = u - model.tensor("damping", q.device, q.dtype) * v

        if not self.constraint_mode:
            if kin is None:  # no contact: no contact force
                fext = None
                f_world, w_local, depth = (self._zeros(batch + (0, 3)), self._zeros(batch + (0, 6)),
                                           self._zeros(batch + (0,)))
            else:
                fext, f_world, w_local, depth = compute_contact_forces(
                    model, self.options.contacts, self.ground_fn, kin,
                    robot.contact_frame_indices, robot.contact_radii,
                )
            if fext_user is not None:
                fext = fext_user if fext is None else fext + fext_user
            if self._bound_gains:
                u = u + penalty_bounds_torque(self._bound_gains, model.nv, q, v)
            aux_c = {}
            if self.has_constraints:  # joint bounds through PGS
                csys, a, lam = self._constrained_accel(q, v, u, fext, kin, carry)
                aux_c = {"lam": lam, "contact_active": csys.contact_active,
                         "bound_active": csys.bound_active}
            else:
                a = dyn.aba(model, self.gravity, q, v, u, fext)
            return a, {"u_motor": u_motor, "contact_f_world": f_world,
                       "contact_w_local": w_local, "contact_depth": depth, **aux_pairs, **aux_c}

        # Constraint contact mode: the contact forces are the multipliers,
        # written back in the normal basis (reference `engine.cc:3770-3857`)
        csys, a, lam = self._constrained_accel(q, v, u, fext_user, kin, carry)
        if nc:
            off_c = self.cset.row_offsets()[1]
            lam_c = lam[..., off_c : off_c + 4 * nc]
            lam_blocks = lam_c.reshape(lam_c.shape[:-1] + (nc, 4))
            f_world = lie.mv(csys.contact_basis, lam_blocks[..., 0:3])
            tau_n_world = csys.contact_basis[..., :, 2] * lam_blocks[..., 3:4]
            w_local_list = []
            for k, fidx in enumerate(robot.contact_frame_indices):
                rt = frame_placement(model, kin, fidx)[0].transpose(-1, -2)
                f_l = lie.mv(rt, f_world[..., k, :])
                n_l = lie.mv(rt, tau_n_world[..., k, :])
                w_local_list.append(torch.cat([n_l, f_l], dim=-1))
            w_local = torch.stack(w_local_list, dim=-2)
        else:
            f_world = self._zeros(batch + (0, 3))
            w_local = self._zeros(batch + (0, 6))
        return a, {"u_motor": u_motor, "contact_f_world": f_world, "contact_w_local": w_local,
                   "contact_depth": csys.contact_depth, **aux_pairs, "lam": lam,
                   "contact_active": csys.contact_active, "bound_active": csys.bound_active}

    def _constrained_accel(self, q, v, u, fext, kin, carry):
        """The array-form PGS solve of the generic path: (csys, a, lam)."""
        model, cset = self.robot.model, self.cset
        if carry is None:
            carry = self._zero_carry(torch.broadcast_shapes(q.shape[:-1], v.shape[:-1]))
        csys = compute_constraint_system(
            model, cset, self.options.contacts, self.ground_fn, kin,
            joint_space_jacobian(model, kin), q, v, carry["contact_active"],
            carry["bound_active"], distance_ref=carry["distance_ref"],
            rolling_ref=carry["rolling_ref"],
        )
        o = self._solver_opts
        res = solver.constrained_forward_dynamics(
            model, self.gravity, q, v, u, fext, csys, cset, carry["lam"], o.friction, o.torsion,
            o.regularization, o.iter_max,
        )
        return csys, res.qdd, res.lam

    def _integrate_period_generic(self, state: SimState, command, kind: str):
        """One tick of fixed-step Euler or RK4 on the generic path. On the
        card, with no external force registered (a user's force function may
        not be capturable), the tick's eager torch ops are captured once per
        input shape as a CUDA graph and replayed: the same kernels, without
        their launch overhead."""
        carry = self._carry_of(state)
        args = [state.t, state.q, state.v, command] + [carry[k] for k in _PGS_KEYS + _REF_KEYS]

        def run(t, q, v, command, *carry_list):
            return self._generic_period(kind, t, q, v, command, list(carry_list))

        if self.device.type == "cuda" and self.external_force_fn is None:
            q, v, a, aux = self._replay(("generic", kind), run, args)
        else:
            q, v, a, aux = run(*args)
        stepper = state.stepper.replace(iterations=state.stepper.iterations + self.n_substeps)
        return state.replace(q=q, v=v), a, aux, stepper

    def _generic_period(self, kind: str, t, q, v, command, carry_list):
        """The generic tick's substeps, every stage one `dynamics_full`; with
        PGS rows and the stage-chained warm start, the multipliers and active
        sets thread through every stage and the end-of-tick evaluation.
        Returns (q', v', a, aux), q' normalized, a and aux at the tick's end."""
        model = self.robot.model
        carry = dict(zip(_PGS_KEYS, carry_list))
        refs = dict(zip(_REF_KEYS, carry_list[len(_PGS_KEYS):]))
        dt = self._dt_tick
        if self.has_constraints and self.options.stepper.pgs_stage_warm_start:
            step = steppers.euler_step_stateful if kind == "euler" else steppers.rk4_step_stateful

            def f2(t, q, v, pgs):
                a, aux = self.dynamics_full(t, q, v, command, {**pgs, **refs})
                return a, {k: aux[k] for k in _PGS_KEYS}

            for _ in range(self.n_substeps):
                q, v, _, carry = step(model, f2, t, q, v, dt, carry)
                t = t + dt
        else:
            step = steppers.euler_step if kind == "euler" else steppers.rk4_step
            f = self._accel_fn(command, {**carry, **refs})
            for _ in range(self.n_substeps):
                q, v, _ = step(model, f, t, q, v, dt)
                t = t + dt
        a, aux = self.dynamics_full(t, q, v, command, {**carry, **refs})
        return integ.normalize(model, q), v, a, aux

    def _integrate_period_stages(self, state: SimState, command, kind: str):
        """One tick of fixed-step Euler or RK4 on the spring-damper core,
        stage by stage (jiminy_tpu's per-stage path, which flexibility
        takes): every stage one `_accel_fn` (`cdyn_accel` on the card), then
        `_final_eval` at the tick's end. On the card the tick replays from a
        CUDA graph per input shape, as the generic tick does."""
        model = self.robot.model
        step = steppers.euler_step if kind == "euler" else steppers.rk4_step
        dt = self._dt_tick

        def run(t, q, v, command):
            f = self._accel_fn(command)
            for _ in range(self.n_substeps):
                q, v, _ = step(model, f, t, q, v, dt)
                t = t + dt
            a, aux = self._final_eval(t, q, v, command)
            return integ.normalize(model, q), v, a, aux

        args = [state.t, state.q, state.v, command.expand(state.q.shape[:-1] + command.shape[-1:])]
        if self.device.type == "cuda":
            q, v, a, aux = self._replay(("stages", kind), run, args)
        else:
            q, v, a, aux = run(*args)
        stepper = state.stepper.replace(iterations=state.stepper.iterations + self.n_substeps)
        return state.replace(q=q, v=v), a, aux, stepper

    def _replay(self, name, fn, inputs):
        """`fn(*inputs)` through a CUDA graph captured for these input
        shapes: the inputs are copied into the graph's own, the graph
        replayed, and its outputs `(q, v, a, aux)` copied out (the next
        replay overwrites them). A kernel launched inside the tick is
        launched by every replay: its count (`cdyn.KERNELS`) grows by the
        captured launches at each replay, not at the capture, which
        launches nothing."""
        key = (name,) + tuple((tuple(x.shape), x.dtype) for x in inputs)
        entry = self._graphs.get(key)
        if entry is None:
            static = [x.clone() for x in inputs]
            # Warm up on a side stream (lazy inits stay out of the capture)
            stream = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                for _ in range(2):
                    fn(*static)
            stream.wait_stream(side)
            before = {n: k.launches for n, k in cdyn.KERNELS.items()}
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = fn(*static)
            captured = {}
            for n, k in cdyn.KERNELS.items():
                captured[n], k.launches = k.launches - before[n], before[n]
            entry = self._graphs[key] = (graph, static, out, captured)
        graph, static, (q2, v2, a, aux), captured = entry
        for dst, src in zip(static, inputs):
            dst.copy_(src)
        graph.replay()
        for n, count in captured.items():
            cdyn.KERNELS[n].launches += count
        return q2.clone(), v2.clone(), a.clone(), pytree.map(torch.clone, aux)

    def _constrained_eval(self, q, v, u, u_motor, distance_ref, rolling_ref):
        """The constrained dynamics at one state from a cold start, plain
        torch on any device (jiminy_tpu's `dynamics_full` on its component
        path): acceleration, contact forces (from the multipliers in
        constraint contact mode, else the spring-damper ones), and the solver
        carry."""
        cd, cset, o = self._cdyn_cm, self.cset, self._solver_opts
        model = self.robot.model
        batch = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1])
        damping = np.asarray(model.damping, np.float64)
        if np.any(damping != 0.0):
            u = u - torch.as_tensor(damping, dtype=self.dtype, device=self.device) * v
        if cd.bound_gains:
            u = u + penalty_bounds_torque(cd.bound_gains, model.nv, q, v)
        qc = [q[..., i] for i in range(model.nq)]
        vc = [v[..., i] for i in range(model.nv)]
        no = self._zeros(batch, torch.bool)
        qdd, lam, basis, depth, cact, bact = solver.constrained_accel_full_components(
            cd, cset, qc, vc, [u[..., i] for i in range(model.nv)], o.kp, o.kd,
            o.transition_eps, o.friction, o.torsion, o.regularization, o.iter_max,
            [no] * cset.n_contacts, [no] * cset.n_bounds,
            [self._zeros(batch)] * cset.total_rows,
            [distance_ref[..., k] for k in range(cset.n_distance)],
            [rolling_ref[..., k] for k in range(cset.n_rolling)],
        )
        a = cdyn._stack(qdd, batch, q)

        def rows(comps, width):
            if not comps:
                return self._zeros(batch + (0, width))
            return torch.stack([cdyn._stack(r, batch, q) for r in comps], dim=-2)

        def masks(comps):
            if not comps:
                return self._zeros(batch + (0,), torch.bool)
            return torch.stack([x.expand(batch) for x in comps], dim=-1)

        if cset.n_contacts:
            fw, wl = solver.contact_outputs(cd, cset, qc, lam, basis)
            contacts = {"contact_f_world": rows(fw, 3), "contact_w_local": rows(wl, 6),
                        "contact_depth": cdyn._stack(depth, batch, q)}
        else:
            contacts = cd.aux_outputs(q, v, a)
            contacts.pop("imu_raw")
        return a, {
            "u_motor": u_motor,
            **contacts,
            "lam": torch.movedim(lam, 0, -1),
            "contact_active": masks(cact),
            "bound_active": masks(bact),
        }

    def _rolling_heights(self, q):
        """(..., nr) heights of the rolling frames at `q` (spheres, then
        wheels)."""
        model, cset = self.robot.model, self.cset
        frames = [f for f, _ in cset.sphere_specs] + [f for f, _, _ in cset.wheel_specs]
        if not frames:
            return q.new_zeros(q.shape[:-1] + (0,))
        kin = forward_kinematics(model, q)
        return torch.stack([frame_placement(model, kin, f)[1][..., 2] for f in frames], dim=-1)

    def _tick_time(self, tick):
        return tick.to(self.dtype) * self.tick_period

    # ------------------------------------------------------------------ #
    def reset(self, q0, v0=None) -> SimState:
        """Initial state; `q0` is (nq,) or (B, nq) for B environments. The
        loop closures' lengths and the rolling frames' reference heights are
        those of the reset pose."""
        model = self.robot.model
        q0 = torch.as_tensor(q0, dtype=self.dtype, device=self.device)
        batch = q0.shape[:-1]
        v0 = (
            self._zeros(batch + (model.nv,))
            if v0 is None
            else torch.as_tensor(v0, dtype=self.dtype, device=self.device).expand(batch + (model.nv,))
        )
        q0 = integ.normalize(model, q0)
        command = self._zeros(batch + (self.robot.nmotors,))
        t0 = self._zeros(batch)
        dist_ref = self._zeros(batch + (0,))
        if self.cset.n_distance:
            dist_ref = compute_distance_refs(model, self.cset, forward_kinematics(model, q0))
        roll_ref = self._rolling_heights(q0)
        a0, aux = self._final_eval(t0, q0, v0, command,
                                   self._zero_carry(batch, dist_ref, roll_ref))
        st = SimState(
            t=t0,
            q=q0,
            v=v0,
            a=a0,
            command=command,
            u_motor=aux["u_motor"],
            contact_forces=aux["contact_f_world"],
            stepper=StepperState(
                dt=torch.full(batch, min(self.options.stepper.dt_init,
                                         self.options.stepper.dt_max),
                              dtype=self.dtype, device=self.device),
                iterations=self._zeros(batch, torch.int32),
                iter_failed=self._zeros(batch, torch.int32),
                successive_iter_failed=self._zeros(batch, torch.int32),
                diverged=self._zeros(batch, torch.bool),
            ),
            measurements={},
            tick=self._zeros(batch, torch.int32),
        )
        if "lam" in aux:
            st = st.replace(
                contact_active=aux["contact_active"],
                bound_active=aux["bound_active"],
                lam=aux["lam"],
                distance_ref=dist_ref,
                rolling_ref=roll_ref,
            )
        return self._update_sensors(st, a0, aux)

    def _update_sensors(self, state: SimState, a, aux) -> SimState:
        """Delay- and noise-free measurements: the raw read-outs."""
        robot = self.robot
        groups = list(robot.sensors.groups())
        raws = aux.get("sensor_raws") or {}
        kin = None
        if any(name not in raws and isinstance(g, ImuSensorGroup) for name, g in groups):
            kin = forward_kinematics(robot.model, state.q, state.v, a)
        contact_f = {
            "gravity": self.gravity,
            "contact_forces_local": aux["contact_w_local"][..., 3:6],
            "contact_wrench_local": aux["contact_w_local"],
            "contact_frame_indices": robot.contact_frame_indices,
        }
        meas = {}
        for name, g in groups:
            if name in raws:
                meas[name] = raws[name]
            else:
                meas[name] = g.compute_raw(
                    robot.model, kin, state.q, state.v, a, aux["u_motor"], contact_f
                )
        return state.replace(measurements=meas)

    def _with_solver_carry(self, state: SimState, aux) -> SimState:
        """The state with the solver carry of `aux` (constrained path)."""
        if "lam" not in aux:
            return state
        return state.replace(contact_active=aux["contact_active"],
                             bound_active=aux["bound_active"], lam=aux["lam"])

    def _integrate_period(self, state: SimState, command):
        kind = _FIXED_STEP.get(self.options.stepper.integrator)
        if kind is None:
            return self._integrate_period_dopri(state, command)
        if not self._use_core():
            return self._integrate_period_generic(state, command, kind)
        if self._stagewise:
            return self._integrate_period_stages(state, command, kind)
        cc = command
        if self._cdyn_cm is not None:
            # The loops' lengths, warm-start multipliers, active sets and
            # rolling heights ride the command row
            batch = state.q.shape[:-1]
            cc = torch.cat([command.expand(batch + command.shape[-1:]), state.distance_ref,
                            state.lam, state.contact_active.to(self.dtype),
                            state.bound_active.to(self.dtype), state.rolling_ref], dim=-1)
        q, v, extras = self._get_period_run(kind)(state.q, state.v, cc)
        a, aux = self._unpack_period_extras(extras, command, v, *self._solver_widths())
        stepper = state.stepper.replace(iterations=state.stepper.iterations + self.n_substeps)
        return state.replace(q=integ.normalize(self.robot.model, q), v=v), a, aux, stepper

    def _accel_fn(self, command, carry=None):
        """`a = f(t, q, v)` under a zero-order-held command: on the
        spring-damper core the motor efforts, then `cdyn_accel` (the plain
        `_accel_core` on the CPU); on the generic path `dynamics_full` from
        `carry`."""
        if not self._use_core():
            return lambda t, q, v: self.dynamics_full(t, q, v, command, carry)[0]
        cd = self._cdyn

        def f(t, q, v):
            return cd.accel(q, v, self._joint_torques(command, q, v)[1])

        return f

    def _integrate_period_dopri(self, state: SimState, command):
        """One tick of adaptive DOPRI 5(4) in masked lock-step: trials run over
        the whole batch while any env is short of the tick's end, and an env
        that is done (or diverged) keeps its carry (jiminy_tpu's `jax.vmap`
        of its `lax.while_loop`). A rejected trial keeps q, v and a."""
        opts = self.options.stepper
        model = self.robot.model
        period = self.tick_period
        f = self._accel_fn(command, self._carry_of(state))
        st = state.stepper
        q, v = state.q, state.v
        a = f(state.t, q, v)
        t_local = torch.zeros_like(st.dt)
        dt_pref, iters, fails = st.dt, st.iterations, st.iter_failed
        succ_failed, diverged = st.successive_iter_failed, st.diverged
        trials = torch.zeros_like(iters)
        while True:
            active = (t_local < period - 1e-12) & ~diverged & (trials < 100000)
            if not bool(active.any()):
                break
            dt_try = torch.minimum(dt_pref, period - t_local)
            q5, v5, err_vec, mag, a_last = steppers.dopri_trial(
                model, f, state.t + t_local, q, v, a, dt_try
            )
            err = steppers.dopri_error_norm(err_vec, mag, opts.tol_abs, opts.tol_rel)
            err = torch.where(torch.isnan(err), torch.full_like(err, math.inf), err)
            ok, dt_new = steppers.dopri_adjust(dt_try, err, opts.dt_min, opts.dt_max)
            # On success keep the preferred dt unless the trial took it (the
            # reference's dtLargest bookkeeping)
            dt_next = torch.where(ok & (dt_try < dt_pref), dt_pref, dt_new)
            succ_next = torch.where(ok, torch.zeros_like(succ_failed), succ_failed + 1)
            take, take_v = active & ok, (active & ok)[..., None]
            q = torch.where(take_v, q5, q)
            v = torch.where(take_v, v5, v)
            a = torch.where(take_v, a_last, a)
            t_local = torch.where(take, t_local + dt_try, t_local)
            dt_pref = torch.where(active, dt_next, dt_pref)
            iters = iters + take.to(iters.dtype)
            fails = fails + (active & ~ok).to(fails.dtype)
            succ_failed = torch.where(active, succ_next, succ_failed)
            diverged = torch.where(active, succ_next >= opts.successive_iter_failed_max, diverged)
            trials = trials + active.to(trials.dtype)
        q = integ.normalize(model, q)
        a, aux = self._final_eval(state.t + period, q, v, command)
        stepper = StepperState(dt=dt_pref, iterations=iters, iter_failed=fails,
                               successive_iter_failed=succ_failed, diverged=diverged)
        return state.replace(q=q, v=v), a, aux, stepper

    # ------------------------------------------------------------------ #
    @property
    def supports_fused_rollout(self) -> bool:
        """True when `step_rollout_fused` can replace per-period `step` calls:
        fixed-step integration (Euler, RK4) and one sensor tick per controller
        period (clean sensors are all this port accepts), on the spring-damper
        core or the constrained one. Under DOPRI, on the generic path and with
        SPHERICAL (flexibility) joints, the gym layer steps period by period."""
        return (self.options.stepper.integrator in _FIXED_STEP
                and self.n_sensor_periods == 1
                and self._use_core()
                and not self._stagewise)

    def _get_rollout_run(self, cache_key: str, controller, n_periods: int):
        key = ("rollout", cache_key, n_periods)
        run = self._period_runs.get(key)
        if run is None:
            kind = _FIXED_STEP[self.options.stepper.integrator]
            dt = self.tick_period / self.n_substeps
            if self._cdyn_cm is not None:
                run = solver.ConstrainedRolloutIntegrator(
                    self._cdyn_cm, self._tau_c, self.cset, self._solver_opts, dt,
                    self.n_substeps, n_periods, controller, kind, self._imu_frames,
                )
            else:
                run = self._cdyn.make_rollout_integrator(
                    self._tau_c, dt, self.n_substeps, n_periods, controller,
                    integrator=kind, imu_frames=self._imu_frames,
                )
            self._period_runs[key] = run
        return run

    def step_rollout_fused(self, state: SimState, action, controller, carry,
                           n_periods: int, cache_key: str):
        """Advance `n_periods` controller periods with `controller` (a
        component controller: `cdyn.PDComponents` or `cdyn.ZOHPassThrough`)
        re-evaluated in the kernel at every period. Returns (state', carry').
        On the constrained path the solver carry (multipliers, active sets)
        rides behind the controller's carry and is refreshed at every tick."""
        robot = self.robot
        nm, nv = robot.nmotors, robot.nv
        action = torch.as_tensor(action, dtype=self.dtype, device=self.device)
        n_lam, n_cact, n_bact = widths = self._solver_widths()
        carry_ext = carry
        if self._cdyn_cm is not None:
            # The loops' lengths and rolling heights ride the action row,
            # the solver's carry behind the controller's
            action = torch.cat([action.expand(state.q.shape[:-1] + action.shape[-1:]),
                                state.distance_ref, state.rolling_ref], dim=-1)
            carry_ext = torch.cat([carry, state.lam, state.contact_active.to(self.dtype),
                                   state.bound_active.to(self.dtype)], dim=-1)
        run = self._get_rollout_run(cache_key, controller, n_periods)
        q, v, extras = run(state.q, state.v, action, carry_ext)
        n_std = (nv + 10 * len(robot.contact_frame_indices) + 6 * len(self._imu_frames)
                 + n_lam + n_cact + n_bact)
        n_ccrow = extras.shape[-1] - n_std - carry_ext.shape[-1]
        command = extras[..., n_std : n_std + nm]
        carry_new = extras[..., n_std + n_ccrow : n_std + n_ccrow + carry.shape[-1]]
        a, aux = self._unpack_period_extras(extras[..., :n_std], command, v, *widths)
        tick_new = state.tick + n_periods
        st = state.replace(
            t=self._tick_time(tick_new),
            q=integ.normalize(robot.model, q),
            v=v,
            a=a,
            command=command,
            u_motor=aux["u_motor"],
            contact_forces=aux["contact_f_world"],
            stepper=state.stepper.replace(
                iterations=state.stepper.iterations + n_periods * self.n_substeps
            ),
            tick=tick_new,
        )
        return self._update_sensors(self._with_solver_carry(st, aux), a, aux), carry_new

    def step(self, state: SimState, command=None) -> SimState:
        """Advance one controller period with a zero-order-held motor command."""
        command = state.command if command is None else command
        command = torch.as_tensor(command, dtype=self.dtype, device=self.device)
        state = state.replace(command=command)
        for _ in range(self.n_sensor_periods):
            st2, a, aux, stepper = self._integrate_period(state, command)
            tick = state.tick + 1
            st2 = st2.replace(
                t=self._tick_time(tick),
                stepper=stepper,
                u_motor=aux["u_motor"],
                contact_forces=aux["contact_f_world"],
                tick=tick,
            )
            st2 = self._with_solver_carry(st2, aux)
            state = self._update_sensors(st2, a, aux).replace(a=a)
        return state
