"""Rigid-body dynamics on torch tensors (port of `jiminy_tpu.ops.dynamics`):
RNEA, CRBA, ABA with motor armature, and the kinetic and potential energies.

Armature is added to the mass-matrix diagonal in CRBA, to the joint-space
inertia D in ABA and to the generalized torque in RNEA. The tree is static,
so every recursion is a Python loop over joints; per-joint math is small
dense (6,) and (6, 6) algebra batched over the leading dimensions. External
forces `fext` are per-joint spatial wrenches at the joint origin in LOCAL
joint coordinates, (..., nj, 6).

These are the generic path's dynamics (`Engine` with `use_fast_dynamics=False`,
a model the component core refuses: `continuous` joints, or PGS rows beside
spherical joints), plain torch on every device, as jiminy_tpu runs them in
XLA outside its kernels. CRBA also gives the penalty joint-bound gains at the neutral pose.
"""

from __future__ import annotations

from typing import Optional

import torch

from jiminy_torch.models.model import RobotModel
from jiminy_torch.ops import lie
from jiminy_torch.ops.kinematics import (
    forward_kinematics,
    joint_child_placements,
    motion_subspaces,
)


def _consts(model: RobotModel, like: torch.Tensor):
    def t(name):
        return model.tensor(name, like.device, like.dtype)

    return t


def _spatial_gravity(gravity: torch.Tensor, batch, like: torch.Tensor) -> torch.Tensor:
    """-gravity as a spatial acceleration of the world frame (root trick)."""
    g = torch.as_tensor(gravity, dtype=like.dtype, device=like.device).expand(batch + (3,))
    return torch.cat([like.new_zeros(batch + (3,)), -g], dim=-1)


def _joint_quantities(model: RobotModel, q, v):
    """Per-joint placements X_i, motion subspaces S_i and joint velocities."""
    xs = joint_child_placements(model, q)
    ss = motion_subspaces(model, q)
    vqs = [v[..., model.v_slice(i)] for i in range(model.njoints)] if v is not None else None
    return xs, ss, vqs


def _body_inertias(model: RobotModel, like: torch.Tensor) -> torch.Tensor:
    """(nj, 6, 6) spatial inertia of each body about its joint frame (cached
    per model)."""
    key = ("body_inertias", like.device, like.dtype)
    inertias = model._placed.get(key)
    if inertias is None:
        t = _consts(model, like)
        inertias = lie.spatial_inertia_matrix(t("mass"), t("com"), t("inertia"))
        model._placed[key] = inertias
    return inertias


def _st_mul(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """S^T x for a (..., 6, k) subspace and a (..., 6) spatial vector."""
    return lie.mv(s.transpose(-1, -2), x)


def rnea(model: RobotModel, gravity, q: torch.Tensor, v: torch.Tensor, a: torch.Tensor,
         fext: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse dynamics: tau with M(q) a + C(q, v) v + g(q) - J^T fext = tau,
    armature * a included on each dof."""
    batch = q.shape[:-1]
    nj = model.njoints
    xs, ss, vqs = _joint_quantities(model, q, v)
    inertias = _body_inertias(model, q)
    arm = _consts(model, q)("armature")

    a0 = _spatial_gravity(gravity, batch, q)
    vel: list = [None] * nj
    acc: list = [None] * nj
    f: list = [None] * nj
    zero6 = q.new_zeros(batch + (6,))
    for i in range(nj):
        parent = model.parents[i]
        rot, pos = xs[i]
        vj = lie.mv(ss[i], vqs[i])
        aj = lie.mv(ss[i], a[..., model.v_slice(i)])
        v_p = vel[parent] if parent >= 0 else zero6
        a_p = acc[parent] if parent >= 0 else a0
        vel[i] = lie.motion_act_inv(rot, pos, v_p) + vj
        acc[i] = lie.motion_act_inv(rot, pos, a_p) + aj + lie.motion_cross(vel[i], vj)

    taus: list = [None] * nj
    for i in reversed(range(nj)):
        inertia_i = inertias[i]
        f_i = lie.mv(inertia_i, acc[i]) + lie.motion_cross_force(vel[i], lie.mv(inertia_i, vel[i]))
        if f[i] is not None:
            f_i = f_i + f[i]  # the children's accumulated contributions
        if fext is not None:
            f_i = f_i - fext[..., i, :]
        sl = model.v_slice(i)
        taus[i] = _st_mul(ss[i], f_i) + arm[sl] * a[..., sl]
        parent = model.parents[i]
        if parent >= 0:
            f_p = lie.force_act(xs[i][0], xs[i][1], f_i)
            f[parent] = f_p if f[parent] is None else f[parent] + f_p
    if not taus:
        return q.new_zeros(batch + (0,))
    return torch.cat([t_i.expand(batch + t_i.shape[-1:]) for t_i in taus], dim=-1)


def nonlinear_effects(model: RobotModel, gravity, q, v, fext=None) -> torch.Tensor:
    """Coriolis + centrifugal + gravity (- external) torques (pinocchio nle)."""
    a = q.new_zeros(q.shape[:-1] + (model.nv,))
    return rnea(model, gravity, q, v, a, fext)


def _force_act_mat(rot, pos, f_mat: torch.Tensor) -> torch.Tensor:
    """force_act applied columnwise to a (..., 6, k) force matrix."""
    n, fl = f_mat[..., :3, :], f_mat[..., 3:, :]
    f_a = lie.mm(rot, fl)
    n_a = lie.mm(rot, n) + lie.mm(lie.skew(pos), f_a)
    return torch.cat([n_a, f_a], dim=-2)


def _inertia_act_mat(rot, pos, m_mat: torch.Tensor) -> torch.Tensor:
    """motion_act applied columnwise to a (..., 6, k) motion matrix."""
    w, v = m_mat[..., :3, :], m_mat[..., 3:, :]
    w_a = lie.mm(rot, w)
    v_a = lie.mm(rot, v) + lie.mm(lie.skew(pos), w_a)
    return torch.cat([w_a, v_a], dim=-2)


def crba(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """Joint-space mass matrix M(q) (..., nv, nv), armature on the diagonal."""
    batch = q.shape[:-1]
    xs, ss, _ = _joint_quantities(model, q, None)
    inertias = _body_inertias(model, q)
    ic = [inertias[i].expand(batch + (6, 6)) for i in range(model.njoints)]
    m = q.new_zeros(batch + (model.nv, model.nv))
    for i in reversed(range(model.njoints)):
        sl_i = model.v_slice(i)
        s_i = ss[i].expand(batch + ss[i].shape[-2:])
        f = lie.mm(ic[i], s_i)
        m[..., sl_i, sl_i] = lie.mm(s_i.transpose(-1, -2), f)
        j = i
        while model.parents[j] >= 0:
            f = _force_act_mat(xs[j][0], xs[j][1], f)
            j = model.parents[j]
            sl_j = model.v_slice(j)
            s_j = ss[j].expand(batch + ss[j].shape[-2:])
            off = lie.mm(f.transpose(-1, -2), s_j)
            m[..., sl_i, sl_j] = off
            m[..., sl_j, sl_i] = off.transpose(-1, -2)
        parent = model.parents[i]
        if parent >= 0:
            ic[parent] = ic[parent] + lie.inertia_transform(xs[i][0], xs[i][1], ic[i])
    arm = _consts(model, q)("armature")
    return m + torch.eye(model.nv, dtype=q.dtype, device=q.device) * arm[..., None, :]


def aba(model: RobotModel, gravity, q: torch.Tensor, v: torch.Tensor, tau: torch.Tensor,
        fext: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward dynamics by the Articulated Body Algorithm with armature
    (`StYS = S^T IA S + armature`)."""
    batch = q.shape[:-1]
    nj = model.njoints
    xs, ss, vqs = _joint_quantities(model, q, v)
    inertias = _body_inertias(model, q)
    arm = _consts(model, q)("armature")

    vel: list = [None] * nj
    bias_c: list = [None] * nj
    ia: list = [None] * nj
    pa: list = [None] * nj
    zero6 = q.new_zeros(batch + (6,))
    # Pass 1: outward velocities and bias terms
    for i in range(nj):
        parent = model.parents[i]
        vj = lie.mv(ss[i], vqs[i])
        v_p = vel[parent] if parent >= 0 else zero6
        vel[i] = lie.motion_act_inv(xs[i][0], xs[i][1], v_p) + vj
        bias_c[i] = lie.motion_cross(vel[i], vj)
        ia[i] = inertias[i].expand(batch + (6, 6))
        pa_i = lie.motion_cross_force(vel[i], lie.mv(ia[i], vel[i]))
        if fext is not None:
            pa_i = pa_i - fext[..., i, :]
        pa[i] = pa_i

    # Pass 2: inward articulated inertias
    u_mats: list = [None] * nj
    d_invs: list = [None] * nj
    u_vecs: list = [None] * nj
    for i in reversed(range(nj)):
        sl = model.v_slice(i)
        s_i = ss[i].expand(batch + ss[i].shape[-2:])
        u_mat = lie.mm(ia[i], s_i)  # (..., 6, nv_i)
        d = lie.mm(s_i.transpose(-1, -2), u_mat)
        d = d + torch.eye(d.shape[-1], dtype=q.dtype, device=q.device) * arm[..., None, sl]
        # (inv_ex: no host sync, as a captured CUDA graph needs)
        d_inv = 1.0 / d if d.shape[-1] == 1 else torch.linalg.inv_ex(d)[0]
        u_vec = tau[..., sl] - _st_mul(s_i, pa[i])
        u_mats[i], d_invs[i], u_vecs[i] = u_mat, d_inv, u_vec
        parent = model.parents[i]
        if parent >= 0:
            udu = lie.mm(u_mat, lie.mm(d_inv, u_mat.transpose(-1, -2)))
            ia_a = ia[i] - udu
            pa_a = pa[i] + lie.mv(ia_a, bias_c[i]) + lie.mv(u_mat, lie.mv(d_inv, u_vec))
            ia[parent] = ia[parent] + lie.inertia_transform(xs[i][0], xs[i][1], ia_a)
            pa[parent] = pa[parent] + lie.force_act(xs[i][0], xs[i][1], pa_a)

    # Pass 3: outward accelerations
    a0 = _spatial_gravity(gravity, batch, q)
    acc: list = [None] * nj
    qdds: list = [None] * nj
    for i in range(nj):
        parent = model.parents[i]
        a_p = acc[parent] if parent >= 0 else a0
        a_mid = lie.motion_act_inv(xs[i][0], xs[i][1], a_p) + bias_c[i]
        qdd_i = lie.mv(d_invs[i], u_vecs[i] - _st_mul(u_mats[i], a_mid))
        qdds[i] = qdd_i
        s_i = ss[i]
        acc[i] = a_mid + lie.mv(s_i.expand(qdd_i.shape[:-1] + s_i.shape[-2:]), qdd_i)
    if not qdds:
        return q.new_zeros(batch + (0,))
    return torch.cat([x.expand(batch + x.shape[-1:]) for x in qdds], dim=-1)


def kinetic_energy(model: RobotModel, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Total kinetic energy, armature included."""
    batch = q.shape[:-1]
    xs, ss, vqs = _joint_quantities(model, q, v)
    inertias = _body_inertias(model, q)
    vel: list = [None] * model.njoints
    e = q.new_zeros(batch)
    zero6 = q.new_zeros(batch + (6,))
    for i in range(model.njoints):
        parent = model.parents[i]
        vj = lie.mv(ss[i], vqs[i])
        v_p = vel[parent] if parent >= 0 else zero6
        vel[i] = lie.motion_act_inv(xs[i][0], xs[i][1], v_p) + vj
        e = e + 0.5 * torch.einsum("...i,...ij,...j->...", vel[i], inertias[i], vel[i])
    arm = _consts(model, q)("armature")
    return e + 0.5 * torch.sum(arm * v * v, dim=-1)


def potential_energy(model: RobotModel, gravity, q: torch.Tensor) -> torch.Tensor:
    """Gravitational potential energy."""
    kin = forward_kinematics(model, q)
    t = _consts(model, q)
    com, mass = t("com"), t("mass")
    g = torch.as_tensor(gravity, dtype=q.dtype, device=q.device)
    e = q.new_zeros(q.shape[:-1])
    for i in range(model.njoints):
        com_w = lie.se3_apply(kin.rot[..., i, :, :], kin.pos[..., i, :], com[i])
        e = e - mass[i] * torch.sum(g * com_w, dim=-1)
    return e
