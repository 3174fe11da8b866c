"""Trajectory containers with Lie-group interpolation (port of
`jiminy_tpu.telemetry.trajectory`; reference `jiminy_py/dynamics.py:101-392`):
time-indexed robot states with geodesic interpolation, for replay and
imitation datasets. The arrays are host numpy, interpolated at float64.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from jiminy_torch.ops import integrate as integ


@dataclasses.dataclass
class State:
    """Robot state at one instant (reference `jiminy_py.dynamics.State`)."""

    t: float
    q: np.ndarray
    v: Optional[np.ndarray] = None
    a: Optional[np.ndarray] = None
    u: Optional[np.ndarray] = None


@dataclasses.dataclass
class Trajectory:
    """Time series of states with geodesic interpolation (reference
    `jiminy_py.dynamics.Trajectory`)."""

    times: np.ndarray  # (T,)
    qs: np.ndarray  # (T, nq)
    vs: Optional[np.ndarray] = None  # (T, nv)
    robot: Any = None
    # Optional per-step world contact forces (T, nc, 3) or wrenches (T, nc, 6)
    contact_forces: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.times)

    @property
    def duration(self) -> float:
        return float(self.times[-1] - self.times[0])

    def state_at(self, t: float) -> State:
        """Lie-group-interpolated state at time t (clamped to the support)."""
        times = self.times
        t = float(np.clip(t, times[0], times[-1]))
        if len(times) == 1:
            return State(t=t, q=self.qs[0], v=None if self.vs is None else self.vs[0])
        idx = int(np.searchsorted(times, t, side="right") - 1)
        idx = min(max(idx, 0), len(times) - 2)
        t0, t1 = float(times[idx]), float(times[idx + 1])
        alpha = 0.0 if t1 <= t0 else (t - t0) / (t1 - t0)
        if self.robot is not None:
            q = integ.interpolate(
                self.robot.model, torch.as_tensor(self.qs[idx], dtype=torch.float64),
                torch.as_tensor(self.qs[idx + 1], dtype=torch.float64), alpha,
            ).numpy()
        else:
            q = (1 - alpha) * self.qs[idx] + alpha * self.qs[idx + 1]
        v = None
        if self.vs is not None:
            v = (1 - alpha) * self.vs[idx] + alpha * self.vs[idx + 1]
        return State(t=t, q=q, v=v)

    def resample(self, times: np.ndarray) -> "Trajectory":
        states = [self.state_at(t) for t in np.asarray(times)]
        return Trajectory(
            times=np.asarray(times),
            qs=np.stack([s.q for s in states]),
            vs=None if self.vs is None else np.stack([s.v for s in states]),
            robot=self.robot,
        )
