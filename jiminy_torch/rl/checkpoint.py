"""Training checkpoint and resume (port of `jiminy_tpu.rl.checkpoint`,
Orbax there, `torch.save` here).

A checkpoint is the whole `PPOState`: parameters, Adam state, the batched
env states, the episode accumulators and the generators' states, so a run
resumes bit for bit. It is saved as a flat `{path: tensor}` dict (a
generator as its `get_state()` bytes) and loaded with `weights_only=True`.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from jiminy_torch import pytree


def save_checkpoint(path: str, state: Any) -> str:
    path = os.path.abspath(path)
    flat = {}
    for key, leaf in pytree.leaves_with_path(state):
        if isinstance(leaf, torch.Generator):
            leaf = leaf.get_state()
        elif not isinstance(leaf, torch.Tensor):
            raise TypeError(f"checkpoint leaf {key} is a {type(leaf).__name__}, not a tensor")
        flat[key] = leaf.detach().cpu()
    torch.save(flat, path)
    return path


def restore_checkpoint(path: str, target: Any) -> Any:
    """Restore into the structure of `target` (a PPOState from
    `make_train(...)[0]`), each tensor on its target's device with its
    target's dtype and shape, each generator a new one on its target's
    device."""
    flat = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)

    def restore(key, leaf):
        saved = flat[key]
        if isinstance(leaf, torch.Generator):
            g = torch.Generator(leaf.device)
            g.set_state(saved)
            return g
        if saved.shape != leaf.shape or saved.dtype != leaf.dtype:
            raise ValueError(f"checkpoint leaf {key}: {saved.dtype}{tuple(saved.shape)}, "
                             f"target {leaf.dtype}{tuple(leaf.shape)}")
        return saved.to(leaf.device)

    differ = {k for k, _ in pytree.leaves_with_path(target)} ^ set(flat)
    if differ:
        raise KeyError(f"checkpoint and target differ in {sorted(differ)}")
    return pytree.map_with_path(restore, target)
