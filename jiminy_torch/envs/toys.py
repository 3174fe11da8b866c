"""Toy control environments (port of `jiminy_tpu.envs.toys`): CartPole,
Acrobot and the Pendulum swing-up.

The robots come from the reference's own URDF assets (`toys_models/`, read
as data from the JAX package's directory), with the hardware the reference
envs attach in code: one motor on the cart slider, on the acrobot's elbow,
or on the pendulum's pivot. `procedural=True` takes the parametric builders
(`envs/builders.py`) instead.

The cartpole's pole and the acrobot's joints are URDF `continuous` joints
(cos, sin): the component core refuses them, so these two envs run the
generic dynamics path on every device (the acrobot generic ABA, the cartpole
the array-form PGS solve of its slider's bound row). The pendulum's pivot is
a bounded revolute joint: it runs the constrained core, `cdyn_rollout_cm`
and `cdyn_period_cm` on the card.

Resets sample their initial states with an explicit `torch.Generator`
(`reset(batch_size, generator)`); `reset_at(q0, v0)` starts from given
states.
"""

from __future__ import annotations

import numpy as np
import torch

from jiminy_torch.engine.config import EngineOptions, IntegratorType, StepperOptions
from jiminy_torch.engine.robot import Robot
from jiminy_torch.envs import assets, builders
from jiminy_torch.gym.base import BaseEnv
from jiminy_torch.models import joints as jt


def _cmd1(action, lo, hi):
    """An action as a (..., 1) motor command."""
    a = torch.atleast_1d(action)
    if a.shape[-1] != 1:
        a = a[..., None]
    return torch.clamp(a, lo, hi)


def _toy_options(dt=1e-3, **kw):
    return EngineOptions(
        stepper=StepperOptions(integrator=IntegratorType.RUNGE_KUTTA_4, dt_max=dt, **kw),
        controller_update_period=dt,
        sensor_update_period=dt,
    )


class _AngleLayout:
    """q-layout helpers for chains of 1-dof joints, the same for REVOLUTE
    (the procedural models) and REVOLUTE_UNBOUNDED (cos, sin; the URDFs'
    `continuous` joints)."""

    def __init__(self, model):
        self.model = model
        self.joints = [
            (jt.JointType(t), model.idx_q[j], model.idx_v[j])
            for j, t in enumerate(model.joint_types)
        ]

    def angles(self, q):
        """Per-joint scalar positions, (..., nj)."""
        out = []
        for t, iq, _ in self.joints:
            if t == jt.JointType.REVOLUTE_UNBOUNDED:
                out.append(torch.atan2(q[..., iq + 1], q[..., iq]))
            else:
                out.append(q[..., iq])
        return torch.stack(out, dim=-1)

    def cos_sin(self, q, k):
        """(cos, sin) of joint k's angle (read as stored on unbounded joints)."""
        t, iq, _ = self.joints[k]
        if t == jt.JointType.REVOLUTE_UNBOUNDED:
            return q[..., iq], q[..., iq + 1]
        return torch.cos(q[..., iq]), torch.sin(q[..., iq])

    def q_of(self, thetas):
        """The configuration vector of per-joint scalar positions (..., nj)."""
        segs = []
        for k, (t, _, _) in enumerate(self.joints):
            th = thetas[..., k]
            segs += [torch.cos(th), torch.sin(th)] if t == jt.JointType.REVOLUTE_UNBOUNDED else [th]
        return torch.stack(segs, dim=-1)


def _toy_robot(name, procedural, build_fn, motor_joints):
    if procedural:
        return build_fn()
    motors = [{"joint_name": j, "enable_velocity_limit": False} for j in motor_joints]
    model = assets.load_robot(name, has_freeflyer=False).model
    return Robot.build(model, name=name, motors=motors)


class _ToyEnv(BaseEnv):
    """Uniform initial angles and velocities in [-half, half] per joint."""

    def _uniform(self, batch, n, lo, hi, generator):
        u = torch.rand(batch + (n,), generator=generator, dtype=self.dtype,
                       device=generator.device if generator is not None else self.device)
        return (lo + (hi - lo) * u).to(self.device)


class CartPoleEnv(_ToyEnv):
    """Cart-pole balancing (reference `CartPoleJiminyEnv`, the OpenAI-gym
    termination and reward: +1 a step alive, terminate beyond |x| 2.4 or
    |theta| 12 deg). Action: the horizontal force on the cart, continuous in
    [-10, 10] N, or +-10 N with `discrete=True`."""

    X_THRESHOLD = 2.4
    THETA_THRESHOLD = 12.0 * np.pi / 180.0

    def __init__(self, step_dt: float = 0.02, horizon: int = 500, discrete: bool = False,
                 procedural: bool = False, options=None, device=None, dtype=None):
        robot = _toy_robot("cartpole", procedural, builders.build_cartpole, ["slider_to_cart"])
        super().__init__(robot, options or _toy_options(), step_dt=step_dt, horizon=horizon,
                         device=device, dtype=dtype)
        self.discrete = discrete
        self.layout = _AngleLayout(robot.model)

    def _sample_state(self, batch, generator=None):
        th = self._uniform(batch, 2, -0.05, 0.05, generator)
        v = self._uniform(batch, 2, -0.05, 0.05, generator)
        return self.layout.q_of(th), v

    def observe(self, state):
        sim = state.sim
        ang = self.layout.angles(sim.q)
        return torch.stack([ang[..., 0], sim.v[..., 0], ang[..., 1], sim.v[..., 1]], dim=-1)

    def _action_to_command(self, state, action, obs):
        if self.discrete:
            a = torch.atleast_1d(action)
            if a.shape[-1] != 1:
                a = a[..., None]
            return torch.where(a > 0, 10.0, -10.0).to(self.dtype)
        return _cmd1(action, -10.0, 10.0)

    def _compute_reward(self, state, action, next_state):
        return torch.ones(next_state.steps.shape, dtype=self.dtype, device=self.device)

    def _is_terminated(self, state):
        ang = self.layout.angles(state.sim.q)
        return ((torch.abs(ang[..., 0]) > self.X_THRESHOLD)
                | (torch.abs(ang[..., 1]) > self.THETA_THRESHOLD)
                | state.sim.stepper.diverged)


class AcrobotEnv(_ToyEnv):
    """Acrobot swing-up (reference `AcrobotJiminyEnv`): torque at the elbow,
    -1 a step until the tip rises above half the reachable height. `step_dt`
    is the classic 0.2 s, so the 500-step horizon spans 100 s."""

    def __init__(self, step_dt: float = 0.2, horizon: int = 500, continuous: bool = True,
                 procedural: bool = False, options=None, device=None, dtype=None):
        robot = _toy_robot("acrobot", procedural, builders.build_acrobot, ["SecondArmJoint"])
        super().__init__(robot, options or _toy_options(), step_dt=step_dt, horizon=horizon,
                         device=device, dtype=dtype)
        self.continuous = continuous
        self.layout = _AngleLayout(robot.model)
        self.height_threshold = 1.0

    def _sample_state(self, batch, generator=None):
        th = self._uniform(batch, 2, -0.1, 0.1, generator)
        v = self._uniform(batch, 2, -0.1, 0.1, generator)
        return self.layout.q_of(th), v

    def observe(self, state):
        q, v = state.sim.q, state.sim.v
        c1, s1 = self.layout.cos_sin(q, 0)
        c2, s2 = self.layout.cos_sin(q, 1)
        return torch.stack([c1, s1, c2, s2, v[..., 0], v[..., 1]], dim=-1)

    def _tip_height(self, state):
        q = state.sim.q
        c1, s1 = self.layout.cos_sin(q, 0)
        c2, s2 = self.layout.cos_sin(q, 1)
        return -c1 - (c1 * c2 - s1 * s2)  # cos(th1 + th2) = c1 c2 - s1 s2

    def _action_to_command(self, state, action, obs):
        if self.continuous:
            return _cmd1(action, -10.0, 10.0)
        a = torch.atleast_1d(action)
        if a.shape[-1] != 1:
            a = a[..., None]
        return (a - 1.0) * 10.0

    def _compute_reward(self, state, action, next_state):
        up = self._tip_height(next_state) > self.height_threshold
        return torch.where(up, 0.0, -1.0).to(self.dtype)

    def _is_terminated(self, state):
        return (self._tip_height(state) > self.height_threshold) | state.sim.stepper.diverged


class PendulumEnv(_ToyEnv):
    """Torque-limited pendulum swing-up (the reference's
    `simple_pendulum.urdf`): reward -(angle error to upright^2 + 0.1 v^2 +
    0.001 (2 u / u_max)^2)."""

    def __init__(self, step_dt: float = 0.05, horizon: int = 200, procedural: bool = False,
                 torque_max: float = 2.0, options=None, device=None, dtype=None):
        if procedural:
            robot = builders.build_pendulum()
        else:
            model = assets.load_robot("simple_pendulum", has_freeflyer=False).model
            robot = Robot.build(model, name="pendulum",
                                motors=[{"joint_name": "PendulumJoint",
                                         "enable_velocity_limit": False}])
            # The reference pendulum weighs 150 kg: the classic +-2 Nm
            # swing-up torque scales with it
            torque_max = torque_max * float(np.asarray(model.mass).sum()) / 1.0
        self.torque_max = torque_max
        super().__init__(robot, options or _toy_options(), step_dt=step_dt, horizon=horizon,
                         device=device, dtype=dtype)
        self.layout = _AngleLayout(robot.model)

    def _sample_state(self, batch, generator=None):
        th = self._uniform(batch, 1, -np.pi, np.pi, generator)
        v = self._uniform(batch, 1, -1.0, 1.0, generator)
        return self.layout.q_of(th), v

    def observe(self, state):
        q, v = state.sim.q, state.sim.v
        c, s = self.layout.cos_sin(q, 0)
        return torch.stack([c, s, v[..., 0]], dim=-1)

    def _action_to_command(self, state, action, obs):
        return _cmd1(action, -self.torque_max, self.torque_max)

    def _compute_reward(self, state, action, next_state):
        ang = self.layout.angles(next_state.sim.q)[..., 0]
        # The angle's error to upright (q = pi)
        err = torch.atan2(torch.sin(ang - np.pi), torch.cos(ang - np.pi))
        v = next_state.sim.v[..., 0]
        u = torch.atleast_1d(torch.as_tensor(action, dtype=self.dtype, device=self.device))[..., 0]
        u_norm = u / self.torque_max
        return -(err**2 + 0.1 * v**2 + 0.001 * (2.0 * u_norm) ** 2)
