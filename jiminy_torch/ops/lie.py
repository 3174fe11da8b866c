"""Lie-group and spatial-algebra primitives on torch tensors (port of
`jiminy_tpu.ops.lie`, the part the port calls).

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
    """Batched matrix @ vector: (..., i, j), (..., j) -> (..., i).

    A broadcast product and a sum, not a batched GEMM: the operands are
    3x3 and 6x6 blocks over many envs, often a constant against a batch,
    which matmul and einsum materialize and hand to tiny batched GEMMs
    (2.6-4.4x slower on the card, generic_profile.py)."""
    return (m * v.unsqueeze(-2)).sum(-1)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matrix @ matrix, as `mv`."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


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


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype, device=q.device)


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


def mat_to_quat(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (x, y, z, w), w >= 0: of the four
    candidate constructions, the one with the largest pivot."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22
    tw = 1.0 + tr
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22
    eps = _eps(r.dtype)

    def safe_sqrt(t):
        return torch.sqrt(torch.clamp_min(t, eps))

    sw = safe_sqrt(tw) * 2.0
    sx = safe_sqrt(tx) * 2.0
    sy = safe_sqrt(ty) * 2.0
    sz = safe_sqrt(tz) * 2.0
    cand = torch.stack(
        [
            torch.stack([(m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw, 0.25 * sw], dim=-1),
            torch.stack([0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx, (m21 - m12) / sx], dim=-1),
            torch.stack([(m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy, (m02 - m20) / sy], dim=-1),
            torch.stack([(m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz, (m10 - m01) / sz], dim=-1),
        ],
        dim=-2,
    )  # (..., 4 candidates, 4)
    best = torch.argmax(torch.stack([tw, tx, ty, tz], dim=-1), dim=-1)
    q = torch.gather(cand, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = torch.where(q[..., 3:4] < 0.0, -q, q)
    return quat_normalize(q)


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


def log3_quat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> so(3) (angle * axis), angle in [0, pi]."""
    q = torch.where(q[..., 3:4] < 0.0, -q, q)  # w >= 0: angle <= pi
    vec = q[..., :3]
    norm_v = torch.linalg.norm(vec, dim=-1)
    half = torch.atan2(norm_v, q[..., 3])  # in [0, pi/2]
    theta2 = (2.0 * half) ** 2
    small = norm_v < _SMALL_ANGLE
    scale = torch.where(small, 2.0 + theta2 / 12.0,
                        2.0 * half / torch.clamp_min(norm_v, _eps(q.dtype)))
    return vec * scale[..., None]


def log3_mat(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> so(3), through the quaternion."""
    return log3_quat(mat_to_quat(r))


# --------------------------------------------------------------------------- #
# SE(3) placements and spatial vectors
# --------------------------------------------------------------------------- #


def se3_mul(a_rot, a_pos, b_rot, b_pos):
    """Placement of C in A given C in B (b) and B in A (a)."""
    return mm(a_rot, b_rot), mv(a_rot, b_pos) + a_pos


def se3_inv(rot, pos):
    rt = rot.transpose(-1, -2)
    return rt, -mv(rt, pos)


def se3_apply(rot, pos, x: torch.Tensor) -> torch.Tensor:
    """Point coordinates from frame B to frame A, (rot, pos) = B in A."""
    return mv(rot, x) + pos


def motion_act(rot, pos, m: torch.Tensor) -> torch.Tensor:
    """Motion from frame B to frame A coordinates, (rot, pos) = B in A."""
    w_b, v_b = m[..., :3], m[..., 3:]
    w_a = mv(rot, w_b)
    v_a = mv(rot, v_b) + cross(pos, w_a)
    return torch.cat([w_a, v_a], dim=-1)


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


def motion_cross_force(m: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial motion-cross-force product m x* f (dual cross product)."""
    w, v = m[..., :3], m[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, n) + cross(v, fl), cross(w, fl)], dim=-1)


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
