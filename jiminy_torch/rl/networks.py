"""Policy and value networks (port of `jiminy_tpu.rl.networks`): plain
tanh MLPs with flax's numerics.

- The dense weights and biases are float32, as flax's `Dense` keeps its
  params; `log_std` is stored in the env's dtype.
- The forward pass computes in the observations' dtype (the weights are
  cast to it, as flax promotes them), so a float64 env trains at float64.
- Initialisation draws from flax's distributions: `lecun_normal` (a
  normal truncated at two standard deviations) for the hidden layers,
  `orthogonal(0.01)` for both output layers, zero biases, `log_std`
  constant at `log_std_init`.
- The modules live on the card unless `device` says otherwise; their
  draws come from `generator`, which lives on that device.

`apply(params, obs)` is the forward pass over a dict of parameters named as
the module's own (`actor.hidden.0.weight`, ..., `log_std`): PPO trains that
dict, and `ActorCritic.forward` calls the same function.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from jiminy_torch.devices import resolve_device

# flax's truncated-normal variance scaling: the std of a standard normal
# truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _dense(params: Dict[str, torch.Tensor], name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, params[f"{name}.weight"].to(x.dtype), params[f"{name}.bias"].to(x.dtype))


def mlp_apply(params: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor,
              activation: str = "tanh") -> torch.Tensor:
    """The MLP whose parameters are named `{prefix}hidden.<i>.*`, `{prefix}out.*`."""
    act = getattr(torch, activation)
    i = 0
    while f"{prefix}hidden.{i}.weight" in params:
        x = act(_dense(params, f"{prefix}hidden.{i}", x))
        i += 1
    return _dense(params, f"{prefix}out", x)


def apply(params: Dict[str, torch.Tensor], obs: torch.Tensor, activation: str = "tanh"):
    """(mean, log_std broadcast to the mean's shape, value) of `obs` (..., obs_dim)."""
    mean = mlp_apply(params, "actor.", obs, activation)
    value = mlp_apply(params, "critic.", obs, activation)
    return mean, params["log_std"].expand(mean.shape), value[..., 0]


class MLP(nn.Module):
    """Dense layers of widths `features` with `activation` between them."""

    def __init__(self, in_features: int, features: Sequence[int], activation: str = "tanh",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = (in_features, *features)
        kw = dict(dtype=torch.float32, device=resolve_device(device))
        self.hidden = nn.ModuleList(
            nn.utils.skip_init(nn.Linear, a, b, **kw) for a, b in zip(dims[:-2], dims[1:-1])
        )
        self.out = nn.utils.skip_init(nn.Linear, dims[-2], dims[-1], **kw)
        self.activation = activation
        with torch.no_grad():
            for layer in self.hidden:
                std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                layer.bias.zero_()
            nn.init.orthogonal_(self.out.weight, gain=0.01, generator=generator)
            self.out.bias.zero_()

    def forward(self, x):
        return mlp_apply(dict(self.named_parameters()), "", x, self.activation)


class ActorCritic(nn.Module):
    """Gaussian policy and value head with separate torsos."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: Sequence[int] = (256, 256),
                 activation: str = "tanh", log_std_init: float = -0.5,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.activation = activation
        self.actor = MLP(obs_dim, (*hidden, action_dim), activation, device, generator)
        self.critic = MLP(obs_dim, (*hidden, 1), activation, device, generator)
        self.log_std = nn.Parameter(
            torch.full((action_dim,), float(log_std_init), dtype=dtype, device=device)
        )

    def forward(self, obs):
        return apply(dict(self.named_parameters()), obs, self.activation)
