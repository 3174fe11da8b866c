"""Joint-type metadata and per-type kinematic maps (port of
`jiminy_tpu.models.joints`).

Configuration-vector layout matches pinocchio:

| type      | nq | q layout            | nv | v layout (LOCAL frame) |
|-----------|----|---------------------|----|-------------------------|
| FREE      | 7  | x y z  qx qy qz qw  | 6  | v_lin(3) omega(3)       |
| REVOLUTE  | 1  | angle               | 1  | dangle                  |
| PRISMATIC | 1  | displacement        | 1  | ddisplacement           |

REVOLUTE_UNBOUNDED and SPHERICAL are known to the model (URDF "continuous"
joints, flexibility joints) but their kinematics are not ported yet: see
ROADMAP.md queue 1 item 2 (generic ops) and queue 2 (spherical joints).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from jiminy_torch.ops import lie


class JointType(enum.IntEnum):
    FREE = 0
    REVOLUTE = 1
    REVOLUTE_UNBOUNDED = 2
    PRISMATIC = 3
    SPHERICAL = 4


JOINT_NQ = {
    JointType.FREE: 7,
    JointType.REVOLUTE: 1,
    JointType.REVOLUTE_UNBOUNDED: 2,
    JointType.PRISMATIC: 1,
    JointType.SPHERICAL: 4,
}

JOINT_NV = {
    JointType.FREE: 6,
    JointType.REVOLUTE: 1,
    JointType.REVOLUTE_UNBOUNDED: 1,
    JointType.PRISMATIC: 1,
    JointType.SPHERICAL: 3,
}


def _unported(jtype: JointType):
    return NotImplementedError(
        f"joint type {jtype.name} is not ported yet (ROADMAP.md queue 1 item 2, "
        "generic ops; SPHERICAL also queue 2)"
    )


def neutral_q(jtype: JointType) -> np.ndarray:
    """Neutral configuration segment for one joint (host-side numpy)."""
    if jtype == JointType.FREE:
        return np.array([0, 0, 0, 0, 0, 0, 1], dtype=np.float64)
    if jtype == JointType.REVOLUTE_UNBOUNDED:
        return np.array([1, 0], dtype=np.float64)
    if jtype == JointType.SPHERICAL:
        return np.array([0, 0, 0, 1], dtype=np.float64)
    return np.zeros(JOINT_NQ[jtype], dtype=np.float64)


def joint_transform(jtype: int, axis: torch.Tensor, q_j: torch.Tensor):
    """(rot, pos) of the joint's moving frame in its fixed attachment frame."""
    jtype = JointType(jtype)
    batch = q_j.shape[:-1]
    if jtype == JointType.FREE:
        return lie.quat_to_mat(q_j[..., 3:7]), q_j[..., 0:3]
    if jtype == JointType.REVOLUTE:
        rot = lie.exp3_mat(axis * q_j[..., 0:1])
        return rot, torch.zeros(batch + (3,), dtype=q_j.dtype, device=q_j.device)
    if jtype == JointType.PRISMATIC:
        eye = torch.eye(3, dtype=q_j.dtype, device=q_j.device).expand(batch + (3, 3))
        return eye, axis * q_j[..., 0:1]
    raise _unported(jtype)


def motion_subspace(jtype: int, axis: torch.Tensor) -> torch.Tensor:
    """Constant motion subspace S (6, nv_j), rows (angular, linear)."""
    jtype = JointType(jtype)
    if jtype == JointType.FREE:
        s = torch.zeros((6, 6), dtype=axis.dtype, device=axis.device)
        s[0:3, 3:6] = torch.eye(3, dtype=axis.dtype, device=axis.device)
        s[3:6, 0:3] = torch.eye(3, dtype=axis.dtype, device=axis.device)
        return s
    if jtype == JointType.REVOLUTE:
        return torch.cat([axis, torch.zeros_like(axis)], dim=-1)[..., None]
    if jtype == JointType.PRISMATIC:
        return torch.cat([torch.zeros_like(axis), axis], dim=-1)[..., None]
    raise _unported(jtype)


def integrate_joint(jtype: int, q_j: torch.Tensor, dv_j: torch.Tensor) -> torch.Tensor:
    """Lie-group retraction q_j (+) dv_j (SE(3) exponential for the free-flyer)."""
    jtype = JointType(jtype)
    if jtype in (JointType.REVOLUTE, JointType.PRISMATIC):
        return q_j + dv_j
    if jtype == JointType.FREE:
        p, quat = q_j[..., 0:3], q_j[..., 3:7]
        v_lin, omega = dv_j[..., 0:3], dv_j[..., 3:6]
        p_d = _exp6_translation(omega, v_lin)
        rot = lie.quat_to_mat(quat)
        p_new = p + lie.mv(rot, p_d)
        quat_new = lie.quat_normalize(lie.quat_mul(quat, lie.exp3(omega)))
        return torch.cat([p_new, quat_new], dim=-1)
    raise _unported(jtype)


def _exp6_translation(omega: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """V(omega) @ v, the translation of the SE(3) exponential."""
    theta2 = torch.sum(omega * omega, dim=-1)
    small = theta2 < 1e-6
    theta = torch.sqrt(torch.clamp_min(theta2, torch.finfo(omega.dtype).eps ** 2))
    b = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / torch.clamp_min(theta2, 1e-30)
    )
    c = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / torch.clamp_min(theta2 * theta, 1e-30),
    )
    sk = lie.skew(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(sk.shape)
    v_mat = eye + b[..., None, None] * sk + c[..., None, None] * lie.mm(sk, sk)
    return lie.mv(v_mat, v)


def _log6(rot: torch.Tensor, p: torch.Tensor):
    """SE(3) logarithm: (omega, v) with exp6(omega, v) = (rot, p)."""
    omega = lie.log3_mat(rot)
    theta2 = torch.sum(omega * omega, dim=-1)
    small = theta2 < 1e-6
    theta = torch.sqrt(torch.clamp_min(theta2, torch.finfo(p.dtype).eps ** 2))
    # V^{-1} = I - W/2 + (1/t^2 - (1+cos)/(2 t sin)) W^2
    st, ct = torch.sin(theta), torch.cos(theta)
    coef = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 / torch.clamp_min(theta2, 1e-30)) - (1.0 + ct) / torch.clamp_min(2.0 * theta * st, 1e-30),
    )
    sk = lie.skew(omega)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(sk.shape)
    v_inv = eye - 0.5 * sk + coef[..., None, None] * lie.mm(sk, sk)
    return omega, lie.mv(v_inv, p)


def difference_joint(jtype: int, q0_j: torch.Tensor, q1_j: torch.Tensor) -> torch.Tensor:
    """Tangent-space difference q1 (-) q0 for one joint (SE(3) logarithm for
    the free-flyer)."""
    jtype = JointType(jtype)
    if jtype in (JointType.REVOLUTE, JointType.PRISMATIC):
        return q1_j - q0_j
    if jtype == JointType.FREE:
        p0, quat0 = q0_j[..., 0:3], q0_j[..., 3:7]
        p1, quat1 = q1_j[..., 0:3], q1_j[..., 3:7]
        rot0 = lie.quat_to_mat(quat0)
        dp_local = lie.mv(rot0.transpose(-1, -2), p1 - p0)
        drot = lie.quat_to_mat(lie.quat_mul(lie.quat_conjugate(quat0), quat1))
        omega, v = _log6(drot, dp_local)
        return torch.cat([v, omega], dim=-1)
    raise _unported(jtype)


def normalize_joint(jtype: int, q_j: torch.Tensor) -> torch.Tensor:
    jtype = JointType(jtype)
    if jtype == JointType.FREE:
        return torch.cat([q_j[..., 0:3], lie.quat_normalize(q_j[..., 3:7])], dim=-1)
    if jtype in (JointType.REVOLUTE, JointType.PRISMATIC):
        return q_j
    raise _unported(jtype)
