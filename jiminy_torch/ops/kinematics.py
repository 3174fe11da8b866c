"""Forward kinematics, frame kinematics and Jacobians on torch tensors
(port of `jiminy_tpu.ops.kinematics`): env auto-levelling, sensor
read-outs, and the generic dynamics path's contacts, constraint rows and
external forces.

The tree is static, so every function is a Python loop over joints. Spatial
quantities are in LOCAL (moving joint/frame) coordinates.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from jiminy_torch.models import joints as jt
from jiminy_torch.models.model import RobotModel
from jiminy_torch.ops import lie


class KinData(NamedTuple):
    """Stacked per-joint kinematics: world placements + LOCAL spatial vel/acc."""

    rot: torch.Tensor  # (..., nj, 3, 3) joint moving frames in world
    pos: torch.Tensor  # (..., nj, 3)
    vel: Optional[torch.Tensor]  # (..., nj, 6)
    acc: Optional[torch.Tensor]  # (..., nj, 6), gravity-free


def _consts(model: RobotModel, q: torch.Tensor):
    def t(name):
        return model.tensor(name, q.device, q.dtype)

    return t


def motion_subspaces(model: RobotModel, like: torch.Tensor) -> list:
    """Each joint's constant motion subspace S (6, nv_j) on `like`'s device
    and dtype (cached per model)."""
    key = ("motion_subspaces", like.device, like.dtype)
    ss = model._placed.get(key)
    if ss is None:
        axes = model.tensor("joint_axes", like.device, like.dtype)
        ss = [jt.motion_subspace(model.joint_types[i], axes[i]) for i in range(model.njoints)]
        model._placed[key] = ss
    return ss


def joint_child_placements(model: RobotModel, q: torch.Tensor) -> list:
    """Placement of each joint's moving frame in its parent joint's moving
    frame: X_i = X_tree_i o XJ_i(q_i)."""
    t = _consts(model, q)
    jrot, jpos, axes = t("jplacement_rot"), t("jplacement_pos"), t("joint_axes")
    xs = []
    for i in range(model.njoints):
        r_j, p_j = jt.joint_transform(model.joint_types[i], axes[i], q[..., model.q_slice(i)])
        xs.append(lie.se3_mul(jrot[i], jpos[i], r_j, p_j))
    return xs


def forward_kinematics(
    model: RobotModel,
    q: torch.Tensor,
    v: Optional[torch.Tensor] = None,
    a: Optional[torch.Tensor] = None,
) -> KinData:
    xs = joint_child_placements(model, q)
    ss = motion_subspaces(model, q)
    batch = q.shape[:-1]
    zero6 = torch.zeros(batch + (6,), dtype=q.dtype, device=q.device)
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(batch + (3, 3))
    zero3 = torch.zeros(batch + (3,), dtype=q.dtype, device=q.device)
    rots, poss, vels, accs = [], [], [], []
    for i in range(model.njoints):
        parent = model.parents[i]
        x_rot, x_pos = xs[i]
        p_rot, p_pos = (rots[parent], poss[parent]) if parent >= 0 else (eye, zero3)
        r, p = lie.se3_mul(p_rot, p_pos, x_rot, x_pos)
        rots.append(r.expand(batch + (3, 3)))
        poss.append(p.expand(batch + (3,)))
        if v is not None:
            s_i = ss[i]
            vj = lie.mv(s_i, v[..., model.v_slice(i)])
            v_p = vels[parent] if parent >= 0 else zero6
            v_i = lie.motion_act_inv(x_rot, x_pos, v_p) + vj
            vels.append(v_i)
            if a is not None:
                aj = lie.mv(s_i, a[..., model.v_slice(i)])
                a_p = accs[parent] if parent >= 0 else zero6
                accs.append(lie.motion_act_inv(x_rot, x_pos, a_p) + aj + lie.motion_cross(v_i, vj))
    return KinData(
        torch.stack(rots, dim=-3),
        torch.stack(poss, dim=-2),
        torch.stack(vels, dim=-2) if vels else None,
        torch.stack(accs, dim=-2) if accs else None,
    )


def frame_placement(model: RobotModel, kin: KinData, frame_idx: int):
    """World placement (rot, pos) of a frame (pinocchio oMf)."""
    t = _consts(model, kin.pos)
    parent = model.frame_parents[frame_idx]
    frot, fpos = t("fplacement_rot")[frame_idx], t("fplacement_pos")[frame_idx]
    if parent < 0:
        return frot, fpos
    return lie.se3_mul(kin.rot[..., parent, :, :], kin.pos[..., parent, :], frot, fpos)


def frame_velocity_local(model: RobotModel, kin: KinData, frame_idx: int) -> torch.Tensor:
    """Spatial velocity of a frame in LOCAL frame coordinates, (ang, lin)."""
    t = _consts(model, kin.pos)
    parent = model.frame_parents[frame_idx]
    if parent < 0:
        return kin.vel.new_zeros(kin.vel.shape[:-2] + (6,))
    return lie.motion_act_inv(
        t("fplacement_rot")[frame_idx], t("fplacement_pos")[frame_idx], kin.vel[..., parent, :]
    )


def frame_classical_acceleration_local(
    model: RobotModel, kin: KinData, frame_idx: int
) -> torch.Tensor:
    """Classical acceleration of the frame origin, LOCAL coordinates."""
    t = _consts(model, kin.pos)
    parent = model.frame_parents[frame_idx]
    frot, fpos = t("fplacement_rot")[frame_idx], t("fplacement_pos")[frame_idx]
    a = lie.motion_act_inv(frot, fpos, kin.acc[..., parent, :])
    v = lie.motion_act_inv(frot, fpos, kin.vel[..., parent, :])
    a_lin = a[..., 3:] + lie.cross(v[..., :3], v[..., 3:])
    return torch.cat([a[..., :3], a_lin], dim=-1)


def frame_velocity_world_aligned(model: RobotModel, kin: KinData, frame_idx: int) -> torch.Tensor:
    """Spatial velocity in LOCAL_WORLD_ALIGNED coordinates (frame origin,
    world axes)."""
    v_local = frame_velocity_local(model, kin, frame_idx)
    rot = frame_placement(model, kin, frame_idx)[0]
    return torch.cat([lie.mv(rot, v_local[..., :3]), lie.mv(rot, v_local[..., 3:])], dim=-1)


# --------------------------------------------------------------------------- #
# Jacobians
# --------------------------------------------------------------------------- #


def joint_space_jacobian(model: RobotModel, kin: KinData) -> torch.Tensor:
    """World-frame joint-space Jacobian (pinocchio data.J), (..., 6, nv): the
    column block of joint i is its motion subspace moved to world
    coordinates (world origin, world axes)."""
    batch = kin.vel.shape[:-2]
    ss = motion_subspaces(model, kin.pos)
    cols = []
    for i in range(model.njoints):
        rot, pos = kin.rot[..., i, :, :], kin.pos[..., i, :]
        s_i = ss[i].expand(batch + ss[i].shape[-2:])
        cols += [lie.motion_act(rot, pos, s_i[..., :, k]) for k in range(s_i.shape[-1])]
    if not cols:
        return kin.pos.new_zeros(batch + (6, 0))
    return torch.stack(cols, dim=-1)


def ancestor_dof_mask(model: RobotModel, joint_idx: int) -> tuple:
    """Static tuple of the v indices of the joints from `joint_idx` up to
    the root."""
    dofs = []
    j = joint_idx
    while j >= 0:
        sl = model.v_slice(j)
        dofs.extend(range(sl.start, sl.stop))
        j = model.parents[j]
    return tuple(sorted(dofs))


def frame_jacobian_world_aligned(model: RobotModel, kin: KinData, jac_world: torch.Tensor,
                                 frame_idx: int) -> torch.Tensor:
    """Frame Jacobian in LOCAL_WORLD_ALIGNED coordinates, (..., 6, nv), rows
    (ang, lin); the columns of joints that do not move the frame are exactly
    zero (a static mask)."""
    pos = frame_placement(model, kin, frame_idx)[1]
    j_ang = jac_world[..., :3, :]
    j_lin = jac_world[..., 3:, :] - lie.mm(lie.skew(pos), j_ang)
    jac = torch.cat([j_ang, j_lin], dim=-2)
    parent = model.frame_parents[frame_idx]
    if parent < 0:
        return torch.zeros_like(jac)
    key = ("ancestor_mask", parent, jac.device, jac.dtype)
    mask = model._placed.get(key)
    if mask is None:
        dofs = set(ancestor_dof_mask(model, parent))
        mask = torch.tensor([1.0 if d in dofs else 0.0 for d in range(model.nv)],
                            dtype=jac.dtype, device=jac.device)
        model._placed[key] = mask
    return jac * mask
