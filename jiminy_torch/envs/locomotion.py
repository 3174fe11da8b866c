"""Locomotion base env (port of `jiminy_tpu.envs.locomotion.WalkerEnv`)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from jiminy_torch.engine.config import (
    ContactModel,
    ContactOptions,
    EngineOptions,
    IntegratorType,
    StepperOptions,
)
from jiminy_torch.gym.base import BaseEnv, EnvState
from jiminy_torch.ops import lie
from jiminy_torch.ops.kinematics import forward_kinematics, frame_placement


def default_walker_options(robot, simulation_dt: float, contact_model: ContactModel) -> EngineOptions:
    """Explicit-stable spring-damper contact sized on the lightest
    contact-carrying body (omega*dt ~ 0.35), RK4 at `simulation_dt`,
    controller and sensors at 5 * simulation_dt, penalty joint bounds."""
    masses = np.asarray(robot.model.mass, float)
    m_foot = min(
        (float(masses[robot.model.frame_parents[f]]) for f in robot.contact_frame_indices),
        default=1.0,
    )
    m_foot = max(m_foot, 0.05)
    omega = 0.35 / simulation_dt
    weight = float(masses.sum()) * 9.81
    n_c = max(len(robot.contact_frame_indices), 1)
    return EngineOptions(
        contacts=ContactOptions(
            model=contact_model,
            stiffness=min(m_foot * omega**2, 1.0e5),
            damping=2.0 * 0.25 * m_foot * omega,
            friction=1.0,
            transition_velocity=max(0.01, 1.0 * (weight / n_c) * simulation_dt / (2.0 * m_foot)),
        ),
        stepper=StepperOptions(integrator=IntegratorType.RUNGE_KUTTA_4, dt_max=simulation_dt),
        controller_update_period=simulation_dt * 5,
        sensor_update_period=simulation_dt * 5,
        joint_bounds_mode="penalty",
    )


class WalkerEnv(BaseEnv):
    """Floating-base walker: terminate on falls; reward = alive bonus +
    forward velocity tracking - control effort."""

    def __init__(
        self,
        robot,
        nominal_q: np.ndarray,
        step_dt: float = 0.04,
        horizon: int = 500,
        simulation_dt: float = 1.0e-3,
        contact_model: ContactModel = ContactModel.SPRING_DAMPER,
        target_velocity: float = 0.5,
        base_height_min: float = 0.2,
        std_ratio: float = 0.0,
        options: Optional[EngineOptions] = None,
        device=None,
        dtype=None,
    ):
        if std_ratio > 0.0:
            raise NotImplementedError(
                "std_ratio > 0 (randomized resets and models) is not ported yet "
                "(ROADMAP.md queue 1 item 11)"
            )
        if options is None:
            options = default_walker_options(robot, simulation_dt, contact_model)
        super().__init__(robot, options, step_dt=step_dt, horizon=horizon,
                         device=device, dtype=dtype)
        nominal_q = np.asarray(nominal_q, dtype=np.float64).copy()
        if robot.contact_frame_indices and nominal_q.shape[-1] >= 7:
            # Auto-level: the lowest contact point starts 1 mm above the ground
            # (host float64, as the reference configuration is built)
            kin = forward_kinematics(robot.model, torch.as_tensor(nominal_q))
            radii = robot.contact_radii or (0.0,) * len(robot.contact_frame_indices)
            min_z = min(
                float(frame_placement(robot.model, kin, f)[1][2]) - r
                for f, r in zip(robot.contact_frame_indices, radii)
            )
            nominal_q[2] -= min_z - 1e-3
        self.nominal_q = torch.as_tensor(nominal_q, dtype=self.dtype, device=self.device)
        self.target_velocity = target_velocity
        self.base_height_min = base_height_min
        self.std_ratio = std_ratio

    def _sample_state(self, batch: tuple, generator=None):
        model = self.robot.model
        return (
            self.nominal_q.expand(batch + (model.nq,)),
            torch.zeros(batch + (model.nv,), dtype=self.dtype, device=self.device),
        )

    def base_height(self, state: EnvState):
        return state.sim.q[..., 2]

    def base_velocity_x(self, state: EnvState):
        return state.sim.v[..., 0]

    def _compute_reward(self, state, action, next_state):
        vel_err = self.base_velocity_x(next_state) - self.target_velocity
        track = torch.exp(-(vel_err**2) / (2 * 0.25**2))
        effort = torch.sum(torch.square(next_state.sim.u_motor), dim=-1) * 1e-4
        return 1.0 + track - effort

    def _is_terminated(self, state):
        low = self.base_height(state) < self.base_height_min
        up = lie.quat_to_mat(state.sim.q[..., 3:7])[..., 2, 2]
        return low | (up < 0.3) | state.sim.stepper.diverged
