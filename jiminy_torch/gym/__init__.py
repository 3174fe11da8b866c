"""Gym layer: the base env, pipeline wrappers, controller blocks, the
auto-reset and the observation flattening."""

from jiminy_torch.gym.base import AutoResetWrapper, BaseEnv, EnvState
from jiminy_torch.gym.blocks import PDController
from jiminy_torch.gym.pipeline import ControlledEnv
from jiminy_torch.gym.wrappers import FlattenObservation, flatten_pytree

__all__ = ["AutoResetWrapper", "BaseEnv", "EnvState", "PDController", "ControlledEnv",
           "FlattenObservation", "flatten_pytree"]
