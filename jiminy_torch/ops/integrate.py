"""Configuration-space Lie-group operations (port of `jiminy_tpu.ops.integrate`,
`integrate`, `difference`, `normalize` and `interpolate`)."""

from __future__ import annotations

import torch

from jiminy_torch.models import joints as jt
from jiminy_torch.models.model import RobotModel


def integrate(model: RobotModel, q: torch.Tensor, dv: torch.Tensor) -> torch.Tensor:
    """q (+) dv: apply a tangent-space increment to a configuration."""
    segs = [
        jt.integrate_joint(model.joint_types[i], q[..., model.q_slice(i)], dv[..., model.v_slice(i)])
        for i in range(model.njoints)
    ]
    return torch.cat(segs, dim=-1) if segs else q


def difference(model: RobotModel, q0: torch.Tensor, q1: torch.Tensor) -> torch.Tensor:
    """q1 (-) q0: the tangent-space difference with integrate(q0, d) ~= q1."""
    segs = [
        jt.difference_joint(model.joint_types[i], q0[..., model.q_slice(i)], q1[..., model.q_slice(i)])
        for i in range(model.njoints)
    ]
    if not segs:
        return torch.zeros(q0.shape[:-1] + (0,), dtype=q0.dtype, device=q0.device)
    return torch.cat(segs, dim=-1)


def normalize(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """Re-normalize the unit-norm sub-vectors (quaternions)."""
    segs = [
        jt.normalize_joint(model.joint_types[i], q[..., model.q_slice(i)])
        for i in range(model.njoints)
    ]
    return torch.cat(segs, dim=-1) if segs else q


def interpolate(model: RobotModel, q0: torch.Tensor, q1: torch.Tensor, alpha) -> torch.Tensor:
    """Geodesic interpolation between configurations."""
    return integrate(model, q0, difference(model, q0, q1) * alpha)
