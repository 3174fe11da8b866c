"""Gym layer: the base env, pipeline wrappers and controller blocks."""

from jiminy_torch.gym.base import BaseEnv, EnvState
from jiminy_torch.gym.blocks import PDController
from jiminy_torch.gym.pipeline import ControlledEnv

__all__ = ["BaseEnv", "EnvState", "PDController", "ControlledEnv"]
