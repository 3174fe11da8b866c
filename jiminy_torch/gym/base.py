"""BaseEnv: the RL environment over the engine (port of `jiminy_tpu.gym.base`).

Observation = time + agent state + sensor measurements, action = motor
commands; `step` advances `step_dt` (a multiple of the controller period).
Environments are stepped in lock-step on explicitly batched states: `reset`
with `batch_size=B` gives q of shape (B, nq).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from jiminy_torch import pytree
from jiminy_torch.engine.config import EngineOptions
from jiminy_torch.engine.engine import Engine
from jiminy_torch.engine.robot import Robot
from jiminy_torch.engine.state import SimState
from jiminy_torch.ops import cdyn


@dataclasses.dataclass
class EnvState:
    sim: SimState
    steps: torch.Tensor  # (...,) int32 env steps since reset
    last_action: torch.Tensor  # (..., act_dim)
    blocks: Dict[str, Any]  # pipeline block states

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


class BaseEnv:
    """Env API: `reset(batch_size) -> (state, obs)`, `step(state, action) ->
    (state', obs, reward, terminated, truncated, info)`, `observe(state)`."""

    def __init__(
        self,
        robot: Robot,
        options: Optional[EngineOptions] = None,
        step_dt: float = 0.02,
        horizon: int = 1000,
        device=None,
        dtype=None,
    ):
        self.robot = robot
        self.engine = Engine(robot, options, device=device, dtype=dtype)
        self.step_dt = step_dt
        ratio = step_dt / self.engine.control_period
        self.n_ctrl_per_step = max(int(round(ratio)), 1)
        if abs(ratio - self.n_ctrl_per_step) > 1e-9:
            raise ValueError("step_dt must be a multiple of the controller period")
        self.horizon = horizon
        self._component_controllers: Dict[str, Any] = {}
        # Route step() through the whole-env-step rollout kernel when the
        # engine supports it (False forces the per-period path)
        self.use_fused_rollout = True

    @property
    def device(self):
        return self.engine.device

    @property
    def dtype(self):
        return self.engine.dtype

    @property
    def action_size(self) -> int:
        return self.robot.nmotors

    # ------------------------------------------------------------------ #
    # Hooks
    # ------------------------------------------------------------------ #
    def _sample_state(self, batch: tuple, generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Initial (q, v) of shape batch + (n,), drawn with `generator` where
        the env samples; override for other resets."""
        model = self.robot.model
        q = torch.as_tensor(model.neutral(), dtype=self.dtype, device=self.device)
        return q.expand(batch + (model.nq,)), torch.zeros(
            batch + (model.nv,), dtype=self.dtype, device=self.device
        )

    def observe(self, state: EnvState):
        sim = state.sim
        return {
            "t": sim.t,
            "agent_state": {"q": sim.q, "v": sim.v},
            "measurements": dict(sim.measurements),
        }

    def _action_to_command(self, state: EnvState, action, obs):
        return action

    def _compute_reward(self, state: EnvState, action, next_state: EnvState):
        return torch.zeros(state.steps.shape, dtype=self.dtype, device=self.device)

    def _is_terminated(self, state: EnvState):
        return state.sim.stepper.diverged.clone()

    # ------------------------------------------------------------------ #
    # Core API
    # ------------------------------------------------------------------ #
    def reset(self, batch_size: Optional[int] = None,
              generator: Optional[torch.Generator] = None) -> Tuple[EnvState, Any]:
        """Reset `batch_size` environments (None: one unbatched environment),
        their initial states drawn with `generator` (None: torch's default)."""
        batch = () if batch_size is None else (int(batch_size),)
        # (a hook overridden with the one-argument signature draws nothing)
        sample = self._sample_state(batch) if generator is None else self._sample_state(batch, generator)
        return self.reset_at(*sample)

    def reset_at(self, q0, v0) -> Tuple[EnvState, Any]:
        """Reset environments at the given initial states, q0 (..., nq) and
        v0 (..., nv)."""
        q0 = torch.as_tensor(q0, dtype=self.dtype, device=self.device)
        v0 = torch.as_tensor(v0, dtype=self.dtype, device=self.device)
        batch = q0.shape[:-1]
        sim = self.engine.reset(q0, v0)
        state = EnvState(
            sim=sim,
            steps=torch.zeros(batch, dtype=torch.int32, device=self.device),
            last_action=torch.zeros(batch + (self.action_size,), dtype=self.dtype, device=self.device),
            blocks={},
        )
        return state, self.observe(state)

    def _finalize_step(self, state: EnvState, action, sim) -> Tuple:
        next_state = state.replace(
            sim=sim,
            steps=state.steps + 1,
            last_action=torch.as_tensor(action, dtype=self.dtype, device=self.device)
            .expand(state.last_action.shape)
            .clone(),
        )
        obs = self.observe(next_state)
        reward = self._compute_reward(state, action, next_state)
        terminated = self._is_terminated(next_state)
        truncated = next_state.steps >= self.horizon
        return next_state, obs, reward, terminated, truncated, {}

    def step(self, state: EnvState, action):
        action = torch.as_tensor(action, dtype=self.dtype, device=self.device)
        obs = self.observe(state)
        command = self._action_to_command(state, action, obs)
        if self.use_fused_rollout and self.engine.supports_fused_rollout:
            # ZOH command for the whole env step: the rollout kernel with a
            # pass-through controller, one launch for all engine ticks.
            controller = self._component_controllers.get("zoh")
            if controller is None:
                controller = cdyn.ZOHPassThrough(self.robot.nmotors)
                self._component_controllers["zoh"] = controller
            command = command.expand(state.sim.q.shape[:-1] + (self.robot.nmotors,))
            carry = state.sim.q.new_zeros(state.sim.q.shape[:-1] + (0,))
            sim, _ = self.engine.step_rollout_fused(
                state.sim, command, controller, carry, self.n_ctrl_per_step, cache_key="zoh"
            )
            return self._finalize_step(state, action, sim)
        sim = state.sim
        for _ in range(self.n_ctrl_per_step):
            sim = self.engine.step(sim, command)
        return self._finalize_step(state, action, sim)

    def step_with_controller(self, state: EnvState, action, controller, carry):
        """Advance `step_dt` with `controller(env_state_view, carry) ->
        (command, carry)` re-evaluated at every controller period (the
        reference's FunctionalController semantics). Returns the step tuple
        plus the final carry."""
        sim = state.sim
        for _ in range(self.n_ctrl_per_step):
            command, carry = controller(state.replace(sim=sim), carry)
            sim = self.engine.step(sim, command)
        return (*self._finalize_step(state, action, sim), carry)

    def step_with_fused_controller(self, state: EnvState, action, block, block_state):
        """`step_with_controller` with the block's component form run inside
        the `cdyn_rollout` kernel: all controller periods of the env step in
        one launch. Returns the step tuple + the block state."""
        cfn = self._component_controllers.get(block.name)
        if cfn is None:
            cfn = block.component_controller(self)
            self._component_controllers[block.name] = cfn
        action = torch.as_tensor(action, dtype=self.dtype, device=self.device)
        batch = state.sim.q.shape[:-1]
        carry = block_state.reshape(block_state.shape[:-2] + (cfn.n_carry,))
        sim, carry = self.engine.step_rollout_fused(
            state.sim, action.expand(batch + action.shape[-1:]), cfn, carry,
            self.n_ctrl_per_step, cache_key=block.name,
        )
        block_state = carry.reshape(block_state.shape)
        return (*self._finalize_step(state, action, sim), block_state)


def no_span(name: str):
    """A `span(name)` that observes nothing (see `rl.ppo.make_train`)."""
    return contextlib.nullcontext()


class AutoResetWrapper:
    """Vectorized auto-reset (port of `jiminy_tpu.gym.base.AutoResetWrapper`):
    on termination or truncation an env restarts from a fresh sample, so a
    batched rollout keeps its shape. As jiminy_tpu does, every step resets
    the whole batch and then picks, leaf by leaf, the fresh state where an
    env is done: no host sync. The fresh initial states are drawn with the
    `generator` given to `step` (the port's `EnvState` carries no key), or
    given as the states to reset at."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def observe(self, state):
        return self.env.observe(state)

    def reset(self, batch_size=None, generator=None):
        return self.env.reset(batch_size, generator)

    def reset_at(self, q0, v0):
        return self.env.reset_at(q0, v0)

    def step(self, state, action, generator: Optional[torch.Generator] = None,
             reset_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             span=None):
        """One step; a done env restarts from a fresh sample drawn with
        `generator`, or from `reset_state`, a pair (q0, v0) for the whole
        batch. `span(name)` is entered around the "env_step", the "reset"
        and the "pick"."""
        span = span or no_span
        with span("env_step"):
            state, obs, reward, terminated, truncated, info = self.env.step(state, action)
        done = terminated | truncated
        with span("reset"):
            if reset_state is None:
                fresh, fresh_obs = self.env.reset(done.shape[0] if done.ndim else None, generator)
            else:
                fresh, fresh_obs = self.env.reset_at(*reset_state)

        def sel(x, y):
            d = done.reshape(done.shape + (1,) * (x.ndim - done.ndim))
            return torch.where(d, y, x)

        with span("pick"):
            state = pytree.map(sel, state, fresh)
            obs = pytree.map(sel, obs, fresh_obs)
        return state, obs, reward, terminated, truncated, dict(info, done=done)
