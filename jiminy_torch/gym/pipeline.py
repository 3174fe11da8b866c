"""Pipeline wrappers (port of `jiminy_tpu.gym.pipeline`, `ControlledEnv`)."""

from __future__ import annotations

from jiminy_torch.gym.base import BaseEnv


class _Wrapper:
    """Shared plumbing for pipeline layers."""

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

    def step(self, state, action):
        return self.env.step(state, action)


class ControlledEnv(_Wrapper):
    """Attach a controller block: the env action becomes the block's target
    and the block output feeds the inner env (reference
    `ControlledJiminyEnv`, `bases/pipeline.py:1029`)."""

    def __init__(self, env, block, augment_observation: bool = True,
                 use_fused_rollout: bool = True):
        super().__init__(env)
        self.block = block
        self.augment_observation = augment_observation
        # Run the block inside the fused env-step kernel when the engine
        # supports it; False forces the per-period path.
        self.use_fused_rollout = use_fused_rollout

    @property
    def action_size(self):
        return self.block.action_size

    def observe(self, state):
        obs = self.env.observe(state)
        if self.augment_observation and self.block.name in state.blocks:
            obs = dict(obs)
            obs["targets"] = {**obs.get("targets", {}), self.block.name: state.blocks[self.block.name]}
        return obs

    def reset(self, batch_size=None, generator=None):
        return self._with_block(self.env.reset(batch_size, generator)[0])

    def reset_at(self, q0, v0):
        return self._with_block(self.env.reset_at(q0, v0)[0])

    def _with_block(self, state):
        bstate = self.block.init_state(state)
        state = state.replace(blocks={**state.blocks, self.block.name: bstate})
        return state, self.observe(state)

    def step(self, state, action):
        if not isinstance(self.env, BaseEnv):
            raise NotImplementedError(
                "controller blocks stacked above other wrappers are not ported yet "
                "(ROADMAP.md queue 1 item 12)"
            )
        bname = self.block.name
        if (
            self.use_fused_rollout
            and hasattr(self.block, "component_controller")
            and self.env.engine.supports_fused_rollout
        ):
            state, _, reward, terminated, truncated, info, bstate = (
                self.env.step_with_fused_controller(state, action, self.block, state.blocks[bname])
            )
        else:

            def controller(st_view, bs):
                return self.block.compute(action, self.env.observe(st_view), bs)

            state, _, reward, terminated, truncated, info, bstate = self.env.step_with_controller(
                state, action, controller, state.blocks[bname]
            )
        state = state.replace(blocks={**state.blocks, bname: bstate})
        return state, self.observe(state), reward, terminated, truncated, info
