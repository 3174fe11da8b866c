"""Adaptive Dormand-Prince 5(4) on the Lie group (port of
`jiminy_tpu.engine.steppers`, the stateless DOPRI pieces).

The state (q, v) lives on the model's configuration group: increments are
applied with the retraction `q (+) dt * v` and errors measured with
`difference`. The engine runs the adaptive loop in masked lock-step over the
batch (`Engine._integrate_period`): every env takes the same trials, and an
env that has finished its period carries its state through. Error control is
the reference's boost-odeint scheme: the inf-norm of the 5th-vs-4th order
mismatch scaled by `tol_abs + tol_rel * |state|`.

The dynamics callback is `a = f(t, q, v)`; on the card each call is one
`cdyn_accel` launch over the batch. The stage-warm-started variants of the
constrained (PGS) path are not ported (ROADMAP.md queue 1 item 11).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from jiminy_torch.models.model import RobotModel
from jiminy_torch.ops import integrate as integ

# Dormand-Prince 5(4) Butcher tableau (Dormand & Prince 1980); the step
# adaptation constants follow boost::odeint, as the reference does.
_DOPRI_A = np.array(
    [
        [0, 0, 0, 0, 0, 0, 0],
        [1 / 5, 0, 0, 0, 0, 0, 0],
        [3 / 40, 9 / 40, 0, 0, 0, 0, 0],
        [44 / 45, -56 / 15, 32 / 9, 0, 0, 0, 0],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0, 0],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0, 0],
        [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0],
    ]
)
_DOPRI_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_DOPRI_B = _DOPRI_A[-1]  # FSAL: the 5th-order weights are the last row
_DOPRI_E = np.array(
    [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]
)
_SAFETY = 0.8
_ERROR_THRESHOLD = 0.5
_MIN_FACTOR = 0.2
_MAX_FACTOR = 5.0
_ORDER = 5.0


def _weighted(coefs, ks):
    """sum_j coefs[j] * ks[j] in the reference's order (Python float
    coefficients, a zero one included, as jiminy_tpu sums them)."""
    total = 0
    for c, k in zip(coefs, ks):
        total = total + float(c) * k
    return total


def dopri_trial(model: RobotModel, f: Callable, t, q, v, a0, dt):
    """One DOPRI5 trial step of size dt (...,). Returns (q5, v5, err_vec,
    |state|, a_last): the 5th-order solution, the 5th-vs-4th order mismatch
    in the tangent space, the state's magnitude relative to the neutral
    configuration (the error's scale) and the last stage's derivative.

    a0 is the derivative at (t, q, v): FSAL, the accepted step's last stage
    is the next step's first (reference `tryStepImpl`)."""
    dtc = dt[..., None]
    kv = [v]
    ka = [a0]
    for i in range(1, 7):
        dq = _weighted(_DOPRI_A[i][:i], kv) * dtc
        dv = _weighted(_DOPRI_A[i][:i], ka) * dtc
        qi = integ.integrate(model, q, dq)
        vi = v + dv
        kv.append(vi)
        ka.append(f(t + float(_DOPRI_C[i]) * dt, qi, vi))

    q5 = integ.integrate(model, q, _weighted(_DOPRI_B, kv) * dtc)
    v5 = v + _weighted(_DOPRI_B, ka) * dtc
    q4 = integ.integrate(model, q, _weighted(_DOPRI_E, kv) * dtc)
    v4 = v + _weighted(_DOPRI_E, ka) * dtc

    q_zero = torch.as_tensor(model.neutral(), dtype=q.dtype, device=q.device).expand(q.shape)
    state_mag = torch.cat([integ.difference(model, q_zero, q), v], dim=-1)
    err_vec = torch.cat([integ.difference(model, q4, q5), v5 - v4], dim=-1)
    return q5, v5, err_vec, torch.abs(state_mag), ka[-1]


def dopri_error_norm(err_vec, state_mag, tol_abs: float, tol_rel: float):
    scale = tol_abs + tol_rel * state_mag
    return torch.amax(torch.abs(err_vec) / scale, dim=-1)


def dopri_adjust(dt, error, dt_min: float, dt_max: float):
    """Boost-odeint step adaptation (reference `adjustStep`). Returns (ok, dt')."""
    ok = error < 1.0
    grow_thr = min(_ERROR_THRESHOLD, _SAFETY**_ORDER)
    clipped = torch.clamp_min(error, (_MAX_FACTOR / _SAFETY) ** (-_ORDER))
    dt_grow = torch.where(error < grow_thr, dt * _SAFETY * clipped ** (-1.0 / _ORDER), dt)
    dt_shrink = dt * torch.clamp_min(_SAFETY * error ** (-1.0 / (_ORDER - 2.0)), _MIN_FACTOR)
    dt_new = torch.where(ok, dt_grow, dt_shrink)
    return ok, torch.clamp(dt_new, dt_min, dt_max)
