"""Pipeline blocks (port of `jiminy_tpu.gym.blocks`, the PD controller).

A controller maps `(action, obs, state) -> (inner_command, state')` with
torch ops batched over the leading env dimensions. `component_controller`
gives the same law component-wise, the form the fused rollout kernel runs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from jiminy_torch.models import joints as jt
from jiminy_torch.ops import cdyn


def integrate_zoh(state, state_min, state_max, dt):
    """Chained clipped integrators for the (pos, vel, accel) command state
    (reference `integrate_zoh`, `proportional_derivative_controller.py:24-100`).

    state: (..., 3, nm); returns the new state."""
    position, velocity, acceleration = state[..., 0, :], state[..., 1, :], state[..., 2, :]
    pos_min, vel_min, acc_min = state_min[..., 0, :], state_min[..., 1, :], state_min[..., 2, :]
    pos_max, vel_max, acc_max = state_max[..., 0, :], state_max[..., 1, :], state_max[..., 2, :]

    acceleration = torch.clamp(acceleration, acc_min, acc_max)
    velocity_prev = velocity
    velocity = torch.clamp(velocity + acceleration * dt, vel_min, vel_max)

    # Slow down early enough to respect acceleration limits at position bounds
    horizon = torch.clamp(torch.floor(torch.abs(velocity_prev) / acc_max / dt) * dt, min=dt)
    pos_min_delta = pos_min - position
    pos_max_delta = pos_max - position
    drift = torch.where(horizon > dt, 0.5 * (horizon * (horizon - dt)) * acc_max, 0.0)
    v_lo = (pos_min_delta - drift) / horizon
    v_hi = (pos_max_delta + drift) / horizon
    velocity = torch.clamp(velocity, v_lo, v_hi)

    # Velocity after hitting bounds must be cancellable in a single step
    over = torch.abs(velocity) > dt * acc_max
    safe_v = torch.where(torch.abs(velocity) > 1e-12, velocity, 1.0)
    v_lo2 = -torch.clamp((pos_min_delta - drift) / safe_v, min=dt) * acc_max
    v_hi2 = torch.clamp((pos_max_delta + drift) / safe_v, min=dt) * acc_max
    velocity = torch.where(over, torch.clamp(velocity, v_lo2, v_hi2), velocity)

    acceleration = (velocity - velocity_prev) / dt
    position = position + dt * velocity
    return torch.stack([position, velocity, acceleration], dim=-2)


class PDController:
    """Decentralized PD controller on the motor side with position, velocity
    and acceleration bounds and ZOH integration of the command state
    (reference `PDController`, `proportional_derivative_controller.py:301`).

    Action = target motor accelerations; command effort =
    ``kp * ((q* - q) + kd * (v* - v))`` clipped to the effort limits.
    """

    name = "pd_controller"

    def __init__(
        self,
        kp,
        kd,
        target_position_margin: float = 0.0,
        target_velocity_limit: Optional[float] = None,
        target_acceleration_limit: Optional[float] = None,
    ):
        self.kp = np.asarray(kp, dtype=np.float64)
        self.kd = np.asarray(kd, dtype=np.float64)
        self.target_position_margin = target_position_margin
        self.target_velocity_limit = target_velocity_limit
        self.target_acceleration_limit = target_acceleration_limit

    def setup(self, env):
        m = env.robot.motors
        model = env.robot.model
        qidx = np.asarray(m.q_indices)
        pos_lo = model.position_limit_lower[qidx] * m.mechanical_reduction
        pos_hi = model.position_limit_upper[qidx] * m.mechanical_reduction
        vel = np.asarray(m.velocity_limit, np.float64)
        if self.target_velocity_limit is not None:
            vel = np.minimum(vel, self.target_velocity_limit)
        acc = np.full_like(vel, self.target_acceleration_limit or 1.0e5)
        self._state_min = np.stack([pos_lo + self.target_position_margin, -vel, -acc], axis=-2)
        self._state_max = np.stack([pos_hi - self.target_position_margin, vel, acc], axis=-2)
        self._effort_limit = np.asarray(m.effort_limit, np.float64)
        self._dt = env.engine.control_period
        self._device, self._dtype = env.engine.device, env.engine.dtype
        self.action_size = m.nmotors
        self.action_low = -acc
        self.action_high = acc
        self._env = env
        return self

    def _t(self, x):
        return torch.as_tensor(x, dtype=self._dtype, device=self._device)

    def init_state(self, env_state):
        """Command state seeded from the current encoder measurement."""
        enc = env_state.sim.measurements["encoder"]  # (..., nm, 2)
        zero = torch.zeros_like(enc[..., 0])
        return torch.stack([enc[..., 0], enc[..., 1] * 0.0, zero], dim=-2)

    def compute(self, action, obs, block_state):
        cs = block_state.clone()
        cs[..., 2, :] = action
        cs = integrate_zoh(cs, self._t(self._state_min), self._t(self._state_max), self._dt)
        enc = obs["measurements"]["encoder"]
        q_err = cs[..., 0, :] - enc[..., 0]
        v_err = cs[..., 1, :] - enc[..., 1]
        u = self._t(self.kp) * (q_err + self._t(self.kd) * v_err)
        eff = self._t(self._effort_limit)
        return torch.clamp(u, -eff, eff), cs

    def component_controller(self, env) -> cdyn.PDComponents:
        """Component-wise form of `compute` for the fused rollout: the ZOH
        command-state integration, the encoder read-out and the PD law as
        per-motor scalar math, run in the `cdyn_rollout` kernel on the card
        (`pd_controller` in csrc/cdyn.cu) and by its plain version on the CPU.
        Carry layout = the flattened (3, nm) command state."""
        enc = env.robot.sensors.encoder
        nm = env.robot.motors.nmotors
        kp = np.broadcast_to(self.kp, (nm,))
        kd = np.broadcast_to(self.kd, (nm,))
        return cdyn.PDComponents(
            dt=float(self._dt),
            kp=tuple(float(x) for x in kp),
            kd=tuple(float(x) for x in kd),
            smin=tuple(tuple(float(x) for x in row) for row in self._state_min),
            smax=tuple(tuple(float(x) for x in row) for row in self._state_max),
            eff=tuple(float(x) for x in self._effort_limit),
            red=tuple(float(x) for x in enc.reduction),
            q_indices=tuple(enc.q_indices),
            v_indices=tuple(enc.v_indices),
            joint_side=tuple(bool(x) for x in enc.joint_side),
            unbounded=tuple(jt.JointType(t) == jt.JointType.REVOLUTE_UNBOUNDED
                            for t in enc.joint_types),
        )
