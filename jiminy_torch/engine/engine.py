"""The simulation engine (port of `jiminy_tpu.engine.engine`): the
spring-damper path and the constrained (PGS) path of joint bounds and
ground contacts (`ContactModel.CONSTRAINT`, `joint_bounds_mode="constraint"`).

- `Engine.reset(q0, v0)` builds the initial state; its dynamics evaluation
  goes through `cdyn_accel` on the card (spring-damper) or the plain
  constrained solve (constrained; plain torch on the card, as jiminy_tpu
  runs it in XLA outside its kernels).
- `Engine.step(state, command)` advances one controller period with a
  zero-order-held command through `cdyn_period` or `cdyn_period_cm` (Euler,
  RK4), or, under adaptive DOPRI 5(4) on the spring-damper path, through
  trials of six `cdyn_accel` evaluations each in masked lock-step over the
  batch (`engine/steppers.py`).
- `Engine.step_rollout_fused(...)` advances a whole env step, the controller
  re-evaluated at every period, through `cdyn_rollout` or `cdyn_rollout_cm`.

Unlike jiminy_tpu, which runs its component core only off the CPU, the port
always runs the component core: the plain versions on the CPU, the kernels on
the card, so the CPU tests exercise the same control flow as the card.
Options whose code paths are not ported raise `NotImplementedError` naming
the ROADMAP.md item that will port them.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from jiminy_torch.devices import resolve_device, resolve_dtype
from jiminy_torch.engine import solver, steppers
from jiminy_torch.engine.config import ContactModel, EngineOptions, IntegratorType
from jiminy_torch.engine.constraints import build_constraint_set
from jiminy_torch.engine.hardware import ImuSensorGroup
from jiminy_torch.engine.robot import Robot
from jiminy_torch.engine.state import SimState, StepperState
from jiminy_torch.models import joints as jt
from jiminy_torch.ops import cdyn
from jiminy_torch.ops import dynamics as dyn
from jiminy_torch.ops import integrate as integ
from jiminy_torch.ops.kinematics import forward_kinematics

_FIXED_STEP = {
    IntegratorType.EULER_EXPLICIT: "euler",
    IntegratorType.RUNGE_KUTTA_4: "rk4",
}


def _refuse_unported(robot: Robot, opts: EngineOptions) -> None:
    if opts.use_fast_dynamics is False:
        raise NotImplementedError(
            "use_fast_dynamics=False asks for the generic dynamics path, which is "
            "not ported yet (ROADMAP.md queue 1 item 2, generic ops)"
        )
    if opts.world.ground_profile is not None:
        raise NotImplementedError(
            "ground profiles (terrain) are not ported yet (ROADMAP.md queue 1 item 13 "
            "and queue 2, terrain height_components)"
        )
    if opts.joint_bounds_mode not in ("constraint", "penalty", "none"):
        raise ValueError(f"unknown joint_bounds_mode {opts.joint_bounds_mode!r}")
    for name, g in robot.sensors.groups():
        if not g.is_clean():
            raise NotImplementedError(
                f"sensor group '{name}' declares noise, bias or delay, which is not "
                "ported yet (ROADMAP.md queue 1 item 11)"
            )


class Engine:
    """Single-robot engine holding the static configuration."""

    def __init__(self, robot: Robot, options: Optional[EngineOptions] = None,
                 device=None, dtype=None):
        self.robot = robot
        self.options = opts = options or EngineOptions()
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        _refuse_unported(robot, opts)
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
        # bounds the joint bounds, are PGS rows; with no rows, the
        # spring-damper core.
        self.constraint_mode = opts.contacts.model == ContactModel.CONSTRAINT
        self.cset = build_constraint_set(
            robot,
            include_contacts=self.constraint_mode,
            include_bounds=opts.joint_bounds_mode == "constraint",
        )
        gravity = tuple(float(g) for g in opts.world.gravity)
        self._cdyn = self._cdyn_cm = None
        if self.cset.total_rows:
            if opts.stepper.integrator not in _FIXED_STEP:
                raise NotImplementedError(
                    "adaptive DOPRI beside PGS rows (constraint contacts or bounds) is not "
                    "ported yet: its stage-warm-started trial, jiminy_tpu's "
                    "dopri_trial_stateful (ROADMAP.md queue 1 item 11)"
                )
            if not self.constraint_mode and robot.contact_frame_indices:
                raise NotImplementedError(
                    "joint bounds through the PGS solver beside spring-damper contacts "
                    "are not ported yet (ROADMAP.md queue 1 item 9); use 'penalty', or "
                    "constraint contacts"
                )
            # Component CRBA/NLE for the PGS path; penalty bounds are not
            # applied beside PGS rows (as in jiminy_tpu)
            self._cdyn_cm = cdyn.ComponentDynamics(robot.model, gravity)
            self._solver_opts = solver.solver_options(opts)
        elif self.constraint_mode:
            raise NotImplementedError(
                "constraint contact mode with no constraint rows runs the generic "
                "dynamics path, which is not ported yet (ROADMAP.md queue 1 item 2)"
            )
        else:
            self._cdyn = cdyn.ComponentDynamics(
                robot.model,
                gravity,
                contact_opts=opts.contacts,
                contact_frames=robot.contact_frame_indices,
                contact_radii=robot.contact_radii,
                bound_gains=self._bound_gains,
            )
        self._tau_c = self._build_tau_c()
        self._period_runs = {}

    def _build_penalty_bound_gains(self) -> dict:
        """Per-joint penalty gains kp = m_ii w^2, kd = 2 m_ii w, with m_ii the
        apparent joint inertia at the neutral pose."""
        model = self.robot.model
        candidates = list(self.robot.motors.joint_indices) if self.robot.motors else []
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

    def _final_eval(self, q, v, command):
        """(a, aux) at a state: `cdyn_accel` then the plain aux outputs, or
        on the constrained path the plain constrained solve from a cold
        start (no warm start, no active set), as at jiminy_tpu's reset."""
        u_motor, u = self._compute_efforts(command, v)
        if self._cdyn_cm is not None:
            return self._constrained_eval(q, v, u, u_motor)
        a = self._cdyn.accel(q, v, u)
        auxc = self._cdyn.aux_outputs(q, v, a, imu_frames=self._imu_frames)
        imu_raw = auxc.pop("imu_raw")
        raws = {}
        off = 0
        for name, frames in self._imu_group_frames:
            raws[name] = imu_raw[..., off : off + len(frames), :]
            off += len(frames)
        return a, {"u_motor": u_motor, "sensor_raws": raws, **auxc}

    def _constrained_eval(self, q, v, u, u_motor):
        """The constrained dynamics at one state, plain torch on any device
        (jiminy_tpu's `dynamics_full` in constraint mode): acceleration,
        contact forces from the multipliers, and the solver carry."""
        cd, cset, o = self._cdyn_cm, self.cset, self._solver_opts
        model = self.robot.model
        batch = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1])
        damping = np.asarray(model.damping, np.float64)
        if np.any(damping != 0.0):
            u = u - torch.as_tensor(damping, dtype=self.dtype, device=self.device) * v
        qc = [q[..., i] for i in range(model.nq)]
        vc = [v[..., i] for i in range(model.nv)]
        no = self._zeros(batch, torch.bool)
        qdd, lam, basis, depth, cact, bact = solver.constrained_accel_full_components(
            cd, cset, qc, vc, [u[..., i] for i in range(model.nv)], o.kp, o.kd,
            o.transition_eps, o.friction, o.torsion, o.regularization, o.iter_max,
            [no] * cset.n_contacts, [no] * cset.n_bounds,
            [self._zeros(batch)] * cset.total_rows,
        )
        fw, wl = solver.contact_outputs(cd, cset, qc, lam, basis)

        def rows(comps, width):
            if not comps:
                return self._zeros(batch + (0, width))
            return torch.stack([cdyn._stack(r, batch, q) for r in comps], dim=-2)

        def masks(comps):
            if not comps:
                return self._zeros(batch + (0,), torch.bool)
            return torch.stack([x.expand(batch) for x in comps], dim=-1)

        return cdyn._stack(qdd, batch, q), {
            "u_motor": u_motor,
            "contact_f_world": rows(fw, 3),
            "contact_w_local": rows(wl, 6),
            "contact_depth": cdyn._stack(depth, batch, q),
            "lam": torch.movedim(lam, 0, -1),
            "contact_active": masks(cact),
            "bound_active": masks(bact),
        }

    def _tick_time(self, tick):
        return tick.to(self.dtype) * self.tick_period

    # ------------------------------------------------------------------ #
    def reset(self, q0, v0=None) -> SimState:
        """Initial state; `q0` is (nq,) or (B, nq) for B environments."""
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
        a0, aux = self._final_eval(q0, v0, command)
        st = SimState(
            t=self._zeros(batch),
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
        if self._cdyn_cm is not None:
            st = st.replace(
                contact_active=aux["contact_active"],
                bound_active=aux["bound_active"],
                lam=aux["lam"],
                distance_ref=self._zeros(batch + (0,)),
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
        cc = command
        if self._cdyn_cm is not None:
            # Warm-start multipliers and active sets ride the command row
            batch = state.q.shape[:-1]
            cc = torch.cat([command.expand(batch + command.shape[-1:]), state.lam,
                            state.contact_active.to(self.dtype),
                            state.bound_active.to(self.dtype)], dim=-1)
        q, v, extras = self._get_period_run(kind)(state.q, state.v, cc)
        a, aux = self._unpack_period_extras(extras, command, v, *self._solver_widths())
        stepper = state.stepper.replace(iterations=state.stepper.iterations + self.n_substeps)
        return state.replace(q=integ.normalize(self.robot.model, q), v=v), a, aux, stepper

    def _accel_fn(self, command):
        """`a = f(t, q, v)` under a zero-order-held command: the motor
        efforts, then `cdyn_accel` (the plain `_accel_core` on the CPU)."""
        cd = self._cdyn

        def f(t, q, v):
            return cd.accel(q, v, self._compute_efforts(command, v)[1])

        return f

    def _integrate_period_dopri(self, state: SimState, command):
        """One tick of adaptive DOPRI 5(4) in masked lock-step: trials run over
        the whole batch while any env is short of the tick's end, and an env
        that is done (or diverged) keeps its carry (jiminy_tpu's `jax.vmap`
        of its `lax.while_loop`). A rejected trial keeps q, v and a."""
        opts = self.options.stepper
        model = self.robot.model
        period = self.tick_period
        f = self._accel_fn(command)
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
        a, aux = self._final_eval(q, v, command)
        stepper = StepperState(dt=dt_pref, iterations=iters, iter_failed=fails,
                               successive_iter_failed=succ_failed, diverged=diverged)
        return state.replace(q=q, v=v), a, aux, stepper

    # ------------------------------------------------------------------ #
    @property
    def supports_fused_rollout(self) -> bool:
        """True when `step_rollout_fused` can replace per-period `step` calls:
        fixed-step integration (Euler, RK4) and one sensor tick per controller
        period (clean sensors are all this port accepts), on the spring-damper
        core or the constrained one. Under DOPRI the gym layer steps period by
        period."""
        return (self.options.stepper.integrator in _FIXED_STEP
                and self.n_sensor_periods == 1)

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
