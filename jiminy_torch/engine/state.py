"""Simulation state (port of `jiminy_tpu.engine.state`).

A dataclass of tensors with explicit leading batch dimensions: an unbatched
state has q of shape (nq,), a batch of B environments stepped in lock-step
has q of shape (B, nq) and t of shape (B,). The spring-damper path carries no
constraint-solver state, no sensor delay lines and no random key.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass
class StepperState:
    iterations: torch.Tensor  # (...,) int32 integration substeps taken
    diverged: torch.Tensor  # (...,) bool; fixed-step integration never sets it

    def replace(self, **kw) -> "StepperState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class SimState:
    t: torch.Tensor  # (...,) simulation time
    q: torch.Tensor  # (..., nq)
    v: torch.Tensor  # (..., nv)
    a: torch.Tensor  # (..., nv)
    command: torch.Tensor  # (..., nm) motor-side commanded efforts (ZOH)
    u_motor: torch.Tensor  # (..., nm) realized motor efforts
    contact_forces: torch.Tensor  # (..., nc, 3) ground forces, world axes
    stepper: StepperState
    measurements: Dict[str, torch.Tensor]  # sensor group -> (..., n, ndata)
    tick: torch.Tensor  # (...,) int32 controller-period counter

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)
