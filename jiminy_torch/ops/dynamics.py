"""Rigid-body dynamics on torch tensors (port of `jiminy_tpu.ops.dynamics`).

Only CRBA is ported in this slice: the engine needs the mass-matrix diagonal
at the neutral pose for the penalty joint-bound gains. RNEA and ABA wait for
ROADMAP.md queue 1 item 2 (generic ops); the port's engine runs the
component-dynamics core (`ops/cdyn.py`) instead.
"""

from __future__ import annotations

import torch

from jiminy_torch.models import joints as jt
from jiminy_torch.models.model import RobotModel
from jiminy_torch.ops import lie
from jiminy_torch.ops.kinematics import joint_child_placements


def _force_act_mat(rot, pos, f_mat: torch.Tensor) -> torch.Tensor:
    """force_act applied columnwise to a (..., 6, k) force matrix."""
    n, fl = f_mat[..., :3, :], f_mat[..., 3:, :]
    f_a = lie.mm(rot, fl)
    n_a = lie.mm(rot, n) + lie.mm(lie.skew(pos), f_a)
    return torch.cat([n_a, f_a], dim=-2)


def crba(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """Joint-space mass matrix M(q) (..., nv, nv), armature on the diagonal."""
    batch = q.shape[:-1]

    def t(name):
        return model.tensor(name, q.device, q.dtype)

    xs = joint_child_placements(model, q)
    axes = t("joint_axes")
    ss = [jt.motion_subspace(model.joint_types[i], axes[i]) for i in range(model.njoints)]
    inertias = lie.spatial_inertia_matrix(t("mass"), t("com"), t("inertia"))
    ic = [inertias[i].expand(batch + (6, 6)) for i in range(model.njoints)]
    m = torch.zeros(batch + (model.nv, model.nv), dtype=q.dtype, device=q.device)
    for i in reversed(range(model.njoints)):
        sl_i = model.v_slice(i)
        s_i = ss[i].expand(batch + ss[i].shape[-2:])
        f = lie.mm(ic[i], s_i)
        m[..., sl_i, sl_i] = torch.einsum("...ik,...il->...kl", s_i, f)
        j = i
        while model.parents[j] >= 0:
            f = _force_act_mat(xs[j][0], xs[j][1], f)
            j = model.parents[j]
            sl_j = model.v_slice(j)
            s_j = ss[j].expand(batch + ss[j].shape[-2:])
            off = torch.einsum("...ik,...il->...kl", f, s_j)
            m[..., sl_i, sl_j] = off
            m[..., sl_j, sl_i] = off.transpose(-1, -2)
        parent = model.parents[i]
        if parent >= 0:
            ic[parent] = ic[parent] + lie.inertia_transform(xs[i][0], xs[i][1], ic[i])
    return m + torch.diag_embed(t("armature").expand(batch + (model.nv,)))
