"""Inputs for holding the kernels against their plain versions.

`perturbed_states` draws (q, v, tau) around an env's nominal pose from a numpy
seed: the base lowered so that some feet penetrate the ground, random joint
offsets with some joints pushed past their bounds, a tilted base, random
velocities and torques. `column_errors` and `column_quantile_errors` hold a
kernel's outputs against its plain version column by column. The card tests
and `chip_smoke.py` use them.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def perturbed_states(env, batch: int, seed: int, device=None, dtype=None):
    device = env.device if device is None else device
    dtype = env.dtype if dtype is None else dtype
    model = env.robot.model
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(env.nominal_q.cpu(), np.float64), (batch, 1))
    q[:, 2] += rng.uniform(-0.03, 0.01, size=batch)
    q[:, 7:] += rng.normal(size=(batch, model.nq - 7)) * 0.2
    # Push one joint per env past its upper bound for a quarter of the envs
    n_past = batch // 4
    joints = rng.integers(7, model.nq, size=n_past)
    hi = model.position_limit_upper[joints]
    q[np.arange(n_past), joints] = np.where(np.isfinite(hi), hi + 0.1, q[np.arange(n_past), joints])
    # Small random base rotation
    w = rng.normal(size=(batch, 3)) * 0.1
    th = np.linalg.norm(w, axis=1, keepdims=True)
    quat = np.concatenate([w / th * np.sin(th / 2), np.cos(th / 2)], axis=1)
    q[:, 3:7] = quat
    v = rng.normal(size=(batch, model.nv)) * 0.5
    tau = rng.normal(size=(batch, model.nv)) * 5.0

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return t(q), t(v), t(tau)


def _columns(x: torch.Tensor) -> torch.Tensor:
    x = x.double()
    return x.reshape(-1, x.shape[-1]) if x.dim() else x.reshape(1, 1)


def column_errors(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per output column (last axis): max over envs of |out - ref| divided by
    (1 + max over envs of |ref|). Each column is held to its own scale, so a
    small output is not hidden behind a large one."""
    out, ref = _columns(out), _columns(ref)
    return (out - ref).abs().amax(0) / (1.0 + ref.abs().amax(0))


def column_quantile_errors(out: torch.Tensor, ref: torch.Tensor, q: float = 0.9) -> torch.Tensor:
    """Per output column: the q-quantile over envs of |out - ref| divided by
    the column's typical magnitude, the RMS of `ref` over envs (1 where that
    is 0). A zeroed column scores about 1, as does one wrong in more than a
    share 1 - q of the envs; the rare env whose float32 answer a rounding
    flip of a contact or bound branch moves far does not decide it."""
    out, ref = _columns(out), _columns(ref)
    rms = ref.pow(2).mean(0).sqrt()
    rms = torch.where(rms > 0, rms, torch.ones_like(rms))
    err = (out - ref).abs() / rms
    k = min(err.shape[0], max(1, math.ceil(q * err.shape[0])))
    return torch.kthvalue(err, k, dim=0).values
