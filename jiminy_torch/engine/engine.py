"""The simulation engine, spring-damper path (port of
`jiminy_tpu.engine.engine`).

- `Engine.reset(q0, v0)` builds the initial state; its dynamics evaluation
  goes through `cdyn_accel` on the card.
- `Engine.step(state, command)` advances one controller period with a
  zero-order-held command through `cdyn_period`.
- `Engine.step_rollout_fused(...)` advances a whole env step, the controller
  re-evaluated at every period, through `cdyn_rollout`.

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
from jiminy_torch.engine.config import ContactModel, EngineOptions, IntegratorType
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
    if opts.contacts.model == ContactModel.CONSTRAINT:
        raise NotImplementedError(
            "constraint contact mode is not ported yet (ROADMAP.md queue 1 item 9)"
        )
    if opts.world.ground_profile is not None:
        raise NotImplementedError(
            "ground profiles (terrain) are not ported yet (ROADMAP.md queue 1 item 13 "
            "and queue 2, terrain height_components)"
        )
    if opts.stepper.integrator not in _FIXED_STEP:
        raise NotImplementedError(
            "adaptive DOPRI is not ported yet (ROADMAP.md queue 1 item 11)"
        )
    if opts.joint_bounds_mode == "constraint":
        model = robot.model
        bounded = any(
            jt.JointType(model.joint_types[j]) in (jt.JointType.REVOLUTE, jt.JointType.PRISMATIC)
            and (
                np.isfinite(model.position_limit_lower[model.idx_q[j]])
                or np.isfinite(model.position_limit_upper[model.idx_q[j]])
            )
            for j in range(model.njoints)
        )
        if bounded:
            raise NotImplementedError(
                "joint bounds through the PGS solver (joint_bounds_mode='constraint') "
                "are not ported yet (ROADMAP.md queue 1 item 9); use 'penalty'"
            )
    elif opts.joint_bounds_mode not in ("penalty", "none"):
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
        self._cdyn = cdyn.ComponentDynamics(
            robot.model,
            tuple(float(g) for g in opts.world.gravity),
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
    def _get_period_run(self, kind: str) -> cdyn.PeriodIntegrator:
        run = self._period_runs.get(kind)
        if run is None:
            run = self._cdyn.make_period_integrator(
                self._tau_c,
                self.tick_period / self.n_substeps,
                self.n_substeps,
                integrator=kind,
                imu_frames=self._imu_frames,
            )
            self._period_runs[kind] = run
        return run

    def _unpack_period_extras(self, extras, command, v):
        """Split `[a | f_world | w_local | depth | imu]` into (a, aux)."""
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
        return a, {
            "u_motor": u_motor,
            "contact_f_world": fw,
            "contact_w_local": wl,
            "contact_depth": depth,
            "sensor_raws": raws,
        }

    def _final_eval(self, q, v, command):
        """(a, aux) at a state: `cdyn_accel` then the plain aux outputs."""
        u_motor, u = self._compute_efforts(command, v)
        a = self._cdyn.accel(q, v, u)
        auxc = self._cdyn.aux_outputs(q, v, a, imu_frames=self._imu_frames)
        imu_raw = auxc.pop("imu_raw")
        raws = {}
        off = 0
        for name, frames in self._imu_group_frames:
            raws[name] = imu_raw[..., off : off + len(frames), :]
            off += len(frames)
        return a, {"u_motor": u_motor, "sensor_raws": raws, **auxc}

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
                iterations=self._zeros(batch, torch.int32),
                diverged=self._zeros(batch, torch.bool),
            ),
            measurements={},
            tick=self._zeros(batch, torch.int32),
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

    def _integrate_period(self, state: SimState, command):
        kind = _FIXED_STEP[self.options.stepper.integrator]
        q, v, extras = self._get_period_run(kind)(state.q, state.v, command)
        a, aux = self._unpack_period_extras(extras, command, v)
        stepper = state.stepper.replace(iterations=state.stepper.iterations + self.n_substeps)
        return state.replace(q=integ.normalize(self.robot.model, q), v=v), a, aux, stepper

    # ------------------------------------------------------------------ #
    @property
    def supports_fused_rollout(self) -> bool:
        """True when `step_rollout_fused` can replace per-period `step` calls:
        one sensor tick per controller period (fixed-step integration and
        clean sensors are all this port accepts)."""
        return self.n_sensor_periods == 1

    def _get_rollout_run(self, cache_key: str, controller, n_periods: int):
        key = ("rollout", cache_key, n_periods)
        run = self._period_runs.get(key)
        if run is None:
            run = self._cdyn.make_rollout_integrator(
                self._tau_c,
                self.tick_period / self.n_substeps,
                self.n_substeps,
                n_periods,
                controller,
                integrator=_FIXED_STEP[self.options.stepper.integrator],
                imu_frames=self._imu_frames,
            )
            self._period_runs[key] = run
        return run

    def step_rollout_fused(self, state: SimState, action, controller, carry,
                           n_periods: int, cache_key: str):
        """Advance `n_periods` controller periods with `controller` (a
        component controller: `cdyn.PDComponents` or `cdyn.ZOHPassThrough`)
        re-evaluated in the kernel at every period. Returns (state', carry')."""
        robot = self.robot
        nm, nv = robot.nmotors, robot.nv
        action = torch.as_tensor(action, dtype=self.dtype, device=self.device)
        run = self._get_rollout_run(cache_key, controller, n_periods)
        q, v, extras = run(state.q, state.v, action, carry)
        n_std = self._cdyn.n_extra(self._imu_frames)
        command = extras[..., n_std : n_std + nm]
        carry_new = extras[..., n_std + nm : n_std + nm + carry.shape[-1]]
        a, aux = self._unpack_period_extras(extras[..., :n_std], command, v)
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
        return self._update_sensors(st, a, aux), carry_new

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
            state = self._update_sensors(st2, a, aux).replace(a=a)
        return state
