"""Observation wrappers (port of `jiminy_tpu.gym.wrappers`: `flatten_pytree`
and `FlattenObservation`; the filter, normalize, scale and frame-stack
wrappers wait for ROADMAP.md queue 1 item 12)."""

from __future__ import annotations

import torch

from jiminy_torch import pytree
from jiminy_torch.gym.pipeline import _Wrapper


def flatten_pytree(obs, batch_ndim: int = 0) -> torch.Tensor:
    """Flatten a nested observation to one vector per env, keeping the first
    `batch_ndim` (env-batch) axes of every leaf. Leaves go in
    `jax.tree.leaves` order (dict keys sorted, recursively), each cast to
    the first leaf's dtype, so a policy trained on jiminy_tpu's vectors
    reads the same entries here."""
    leaves = pytree.leaves(obs)
    if not leaves:
        return torch.zeros((0,))
    lead = tuple(leaves[0].shape[:batch_ndim])
    return torch.cat([x.reshape(lead + (-1,)).to(leaves[0].dtype) for x in leaves], dim=-1)


class FlattenObservation(_Wrapper):
    """Flatten the nested observation into one vector (reference
    `FlattenObservation`)."""

    def observe(self, state):
        # `steps` carries exactly the env-batch axes
        return flatten_pytree(self.env.observe(state), state.steps.ndim)

    def reset(self, batch_size=None, generator=None):
        state, _ = self.env.reset(batch_size, generator)
        return state, self.observe(state)

    def reset_at(self, q0, v0):
        state, _ = self.env.reset_at(q0, v0)
        return state, self.observe(state)

    def step(self, state, action):
        state, _, r, te, tr, info = self.env.step(state, action)
        return state, self.observe(state), r, te, tr, info
