"""Simulation state (port of `jiminy_tpu.engine.state`).

A dataclass of tensors with explicit leading batch dimensions: an unbatched
state has q of shape (nq,), a batch of B environments stepped in lock-step
has q of shape (B, nq) and t of shape (B,). The constrained (PGS) path
carries its solver state: the warm-start multipliers and the active-set
hysteresis masks. Sensor delay lines and a random key are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class StepperState:
    dt: torch.Tensor  # (...,) the adaptive step size DOPRI tries next
    iterations: torch.Tensor  # (...,) int32 integration substeps taken (accepted)
    iter_failed: torch.Tensor  # (...,) int32 rejected DOPRI trials
    successive_iter_failed: torch.Tensor  # (...,) int32
    diverged: torch.Tensor  # (...,) bool; set by DOPRI after too many rejections in a row

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
    # Constrained-path carry (zero-width on the spring-damper path):
    contact_active: Optional[torch.Tensor] = None  # (..., nc) bool hysteresis state
    bound_active: Optional[torch.Tensor] = None  # (..., nb) bool
    lam: Optional[torch.Tensor] = None  # (..., N) warm-start PGS multipliers
    distance_ref: Optional[torch.Tensor] = None  # (..., nd) loop-closure lengths
    rolling_ref: Optional[torch.Tensor] = None  # (..., nr) rolling frames' reference heights

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)
