"""Lie-group and spatial-algebra primitives on torch tensors (port of
`jiminy_tpu.ops.lie`, the part this slice calls).

Conventions are the reference's: quaternions are ``(x, y, z, w)``; a placement
of frame B in frame A is ``(rot, pos)`` with ``x_A = rot @ x_B + pos``; spatial
motion vectors are ``(angular, linear)``, spatial forces ``(torque, force)``.
Every function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch

_SMALL_ANGLE = 1e-3  # radians; Taylor fallback threshold (same as jiminy_tpu)


def _eps(dtype) -> float:
    return float(torch.finfo(dtype).eps)


def mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix @ vector: (..., i, j), (..., j) -> (..., i)."""
    return torch.einsum("...ij,...j->...i", m, v)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matrix @ matrix."""
    return torch.einsum("...ij,...jk->...ik", a, b)


def skew(v: torch.Tensor) -> torch.Tensor:
    """S(v) with S(v) @ u = v x u, (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# --------------------------------------------------------------------------- #
# Quaternions (x, y, z, w)
# --------------------------------------------------------------------------- #


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)], dim=-1),
            torch.stack([2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)], dim=-1),
            torch.stack([2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def exp3(w: torch.Tensor) -> torch.Tensor:
    """so(3) -> quaternion (x, y, z, w)."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp_min(theta2, _eps(w.dtype) ** 2))
    small = theta2 < _SMALL_ANGLE**2
    s_over = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(0.5 * theta) / theta)
    c = torch.where(small, 1.0 - theta2 / 8.0 + theta2 * theta2 / 384.0, torch.cos(0.5 * theta))
    return torch.cat([w * s_over, c], dim=-1)


def exp3_mat(w: torch.Tensor) -> torch.Tensor:
    """so(3) -> rotation matrix (Rodrigues with Taylor fallback)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta2, _eps(w.dtype) ** 2))
    small = theta2 < _SMALL_ANGLE**2
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(
        small,
        0.5 - theta2 / 24.0,
        (1.0 - torch.cos(theta)) / torch.clamp_min(theta2, _eps(w.dtype) ** 2),
    )
    s = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(s.shape)
    return eye + a[..., None, None] * s + b[..., None, None] * mm(s, s)


# --------------------------------------------------------------------------- #
# SE(3) placements and spatial vectors
# --------------------------------------------------------------------------- #


def se3_mul(a_rot, a_pos, b_rot, b_pos):
    """Placement of C in A given C in B (b) and B in A (a)."""
    return mm(a_rot, b_rot), mv(a_rot, b_pos) + a_pos


def se3_inv(rot, pos):
    rt = rot.transpose(-1, -2)
    return rt, -mv(rt, pos)


def motion_act_inv(rot, pos, m: torch.Tensor) -> torch.Tensor:
    """Motion from frame A to frame B coordinates, (rot, pos) = B in A."""
    w_a, v_a = m[..., :3], m[..., 3:]
    rt = rot.transpose(-1, -2)
    w_b = mv(rt, w_a)
    v_b = mv(rt, v_a - cross(pos, w_a))
    return torch.cat([w_b, v_b], dim=-1)


def force_act(rot, pos, f: torch.Tensor) -> torch.Tensor:
    """Force from frame B to frame A coordinates, (rot, pos) = B in A."""
    n_b, f_b = f[..., :3], f[..., 3:]
    f_a = mv(rot, f_b)
    n_a = mv(rot, n_b) + cross(pos, f_a)
    return torch.cat([n_a, f_a], dim=-1)


def motion_cross(m: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    w, v = m[..., :3], m[..., 3:]
    w2, v2 = m2[..., :3], m2[..., 3:]
    return torch.cat([cross(w, w2), cross(w, v2) + cross(v, w2)], dim=-1)


def spatial_inertia_matrix(mass, com, inertia_c) -> torch.Tensor:
    """(..., 6, 6) spatial inertia about the frame origin, (ang, lin) blocks."""
    sc = skew(com)
    m = mass[..., None, None]
    i_o = inertia_c - m * mm(sc, sc)
    top = torch.cat([i_o, m * sc], dim=-1)
    eye = torch.eye(3, dtype=com.dtype, device=com.device).expand(sc.shape)
    bot = torch.cat([m * sc.transpose(-1, -2), m * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def inertia_transform(rot, pos, inertia: torch.Tensor) -> torch.Tensor:
    """Spatial inertia given in frame B expressed in frame A: X_F I X_M^{-1}."""
    sp = skew(pos)
    zero = torch.zeros_like(rot)
    rt = rot.transpose(-1, -2)
    xm_inv = torch.cat(
        [torch.cat([rt, zero], dim=-1), torch.cat([-mm(rt, sp), rt], dim=-1)], dim=-2
    )
    xf = torch.cat(
        [torch.cat([rot, mm(sp, rot)], dim=-1), torch.cat([zero, rot], dim=-1)], dim=-2
    )
    return mm(mm(xf, inertia), xm_inv)
