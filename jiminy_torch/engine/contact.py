"""Contact on the generic path (port of `jiminy_tpu.engine.contact`): flat
ground, the reference's Kelvin-Voigt normal force with regularized
friction, the forces of every contact frame as per-joint wrenches, and the
body-to-body narrowphase of collision pairs (self-collision and robot-robot
contact: capsule-capsule, capsule-box and box-box by the separating-axis
test) under the same force law.

The component core (`ops/cdyn.py::ComponentDynamics._contact_fext`)
evaluates the ground force per scalar component; this array form feeds the
generic dynamics (`Engine.dynamics_full`) and its sensor outputs. The
narrowphase is plain tensor code with no host sync and no branch on data,
so the generic tick's CUDA-graph capture takes it: its geometry constants
are placed on the device once (`_const`), before the capture.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from jiminy_torch.engine.config import ContactOptions
from jiminy_torch.models.model import RobotModel
from jiminy_torch.ops import lie
from jiminy_torch.ops.kinematics import KinData, frame_placement, frame_velocity_local


def flat_ground(xy: torch.Tensor):
    """The default ground profile: height 0, normal +z."""
    h = xy.new_zeros(xy.shape[:-1])
    n = xy.new_zeros(xy.shape[:-1] + (3,))
    n[..., 2] = 1.0
    return h, n


def spring_damper_force_world(opts: ContactOptions, normal: torch.Tensor, depth: torch.Tensor,
                              v_contact: torch.Tensor) -> torch.Tensor:
    """The reference's contact force in world axes: a Kelvin-Voigt normal
    force, viscous friction saturated at the transition velocity, blended in
    by tanh of the depth. `depth` < 0 penetrates."""
    v_depth = torch.sum(v_contact * normal, dim=-1)
    f_normal = -torch.clamp(opts.stiffness * depth + opts.damping * v_depth, max=0.0)
    f = f_normal[..., None] * normal
    v_tang = v_contact - v_depth[..., None] * normal
    # Guarded norm, as the component core's `_contact_fext`
    v_norm = torch.sqrt(torch.clamp(torch.sum(v_tang * v_tang, dim=-1), min=1e-24))
    v_ratio = torch.clamp(v_norm / opts.transition_velocity, max=1.0)
    f = f - (opts.friction * v_ratio * f_normal / v_norm)[..., None] * v_tang
    if opts.transition_eps > 1e-12:
        blend = torch.tanh(2.0 * (-depth) / opts.transition_eps)
        f = f * blend[..., None]
    return torch.where((depth < 0.0)[..., None], f, torch.zeros_like(f))


def compute_contact_forces(model: RobotModel, opts: ContactOptions, ground_fn: Optional[Callable],
                           kin: KinData, contact_frame_indices: tuple, contact_radii: tuple = ()):
    """Spring-damper ground forces at every contact frame.

    Returns (fext, f_world, w_local, depth): (..., nj, 6) per-joint LOCAL
    wrenches (ang, lin); (..., nc, 3) the force at each contact point in
    world axes; (..., nc, 6) the wrench in the LOCAL contact frame; (..., nc)
    the signed gap. A radius > 0 makes the contact a sphere whose lowest
    point touches the ground."""
    if ground_fn is None:
        ground_fn = flat_ground
    batch = kin.vel.shape[:-2]
    like = kin.vel
    nc = len(contact_frame_indices)
    fext = like.new_zeros(batch + (model.njoints, 6))
    if nc == 0:
        return (fext, like.new_zeros(batch + (0, 3)), like.new_zeros(batch + (0, 6)),
                like.new_zeros(batch + (0,)))
    if not contact_radii:
        contact_radii = (0.0,) * nc
    f_world_list, w_local_list, depth_list = [], [], []
    for fidx, radius in zip(contact_frame_indices, contact_radii):
        rot, pos = frame_placement(model, kin, fidx)
        v_local = frame_velocity_local(model, kin, fidx)
        v_world = lie.mv(rot, v_local[..., 3:])
        h, n = ground_fn(pos[..., :2])
        n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
        # First-order gap projection
        depth = (pos[..., 2] - h) * n[..., 2]
        if radius > 0.0:
            depth = depth - radius
            d_off = -radius * n
            w_world = lie.mv(rot, v_local[..., :3])
            v_world = v_world + lie.cross(w_world, d_off)
        f_w = spring_damper_force_world(opts, n, depth, v_world)

        # The wrench in the LOCAL contact frame (force sensors)
        rot_t = rot.transpose(-1, -2)
        f_local = lie.mv(rot_t, f_w)
        n_local = lie.mv(rot_t, lie.cross(d_off, f_w)) if radius > 0.0 else torch.zeros_like(f_local)
        w_local = torch.cat([n_local, f_local], dim=-1)

        # Moved to the parent joint's origin, LOCAL joint frame
        parent = model.frame_parents[fidx]
        rot_j = kin.rot[..., parent, :, :]
        pos_j = kin.pos[..., parent, :]
        lever = pos - pos_j
        if radius > 0.0:
            lever = lever + d_off
        tau_w = lie.cross(lever, f_w)
        rjt = rot_j.transpose(-1, -2)
        fext[..., parent, 0:3] += lie.mv(rjt, tau_w)
        fext[..., parent, 3:6] += lie.mv(rjt, f_w)

        f_world_list.append(f_w)
        w_local_list.append(w_local)
        depth_list.append(depth)
    return (fext, torch.stack(f_world_list, dim=-2), torch.stack(w_local_list, dim=-2),
            torch.stack(depth_list, dim=-1))


_CONSTS: dict = {}


def _const(values, like: torch.Tensor) -> torch.Tensor:
    """A tensor of static floats (a geometry's offsets, half extents,
    rotation) on `like`'s device and dtype, placed once and cached: no host
    copy inside a CUDA-graph capture."""
    key = (tuple(np.asarray(values, np.float64).ravel().tolist()), np.shape(values),
           like.device, like.dtype)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(np.asarray(values, np.float64), dtype=like.dtype,
                                           device=like.device)
    return t


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def closest_segment_points(p1, q1, p2, q2, eps: float = 1e-12):
    """Closest points between segments [p1, q1] and [p2, q2] (..., 3): the
    branchless clamped formulation (Ericson, Real-Time Collision Detection
    5.1.9); a zero-length segment degrades to a point."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    b = _dot(d1, d2)
    c = _dot(d1, r)
    f = _dot(d2, r)
    denom = a * e - b * b
    s = torch.where(denom > eps,
                    torch.clamp((b * f - c * e) / torch.clamp(denom, min=eps), 0.0, 1.0), 0.0)
    t = torch.where(e > eps, (b * s + f) / torch.clamp(e, min=eps), 0.0)
    t_cl = torch.clamp(t, 0.0, 1.0)
    s_re = torch.where(a > eps, torch.clamp((b * t_cl - c) / torch.clamp(a, min=eps), 0.0, 1.0),
                       0.0)
    s = torch.where((t < 0.0) | (t > 1.0), s_re, s)
    return p1 + s[..., None] * d1, p2 + t_cl[..., None] * d2


def _geom_kind(g) -> str:
    """A pair geometry's tag; an untagged 4-tuple is a capsule."""
    return g[1] if isinstance(g[1], str) else "capsule"


def _geom_world_segment(kin: KinData, g):
    """World segment of a capsule pair geometry (parent, ["capsule",] r, p0,
    p1): (j, r, a0, a1, rot_j, pos_j)."""
    if isinstance(g[1], str):
        j, _, r, p0, p1 = g
    else:
        j, r, p0, p1 = g
    rot = kin.rot[..., j, :, :]
    pos = kin.pos[..., j, :]
    a0 = pos + lie.mv(rot, _const(p0, pos))
    a1 = pos + lie.mv(rot, _const(p1, pos)) if p1 != p0 else a0
    return j, float(r), a0, a1, rot, pos


def _geom_world_box(kin: KinData, g):
    """World OBB of a box pair geometry (parent, "box", rot9, c, half):
    (j, box_rot (..., 3, 3), box_pos (..., 3), half (3,), rot_j, pos_j)."""
    j, _, rot9, c, half = g
    rot_j = kin.rot[..., j, :, :]
    pos_j = kin.pos[..., j, :]
    rot_l = _const(np.asarray(rot9, np.float64).reshape(3, 3), pos_j)
    box_rot = lie.mm(rot_j, rot_l)
    box_pos = pos_j + lie.mv(rot_j, _const(c, pos_j))
    return j, box_rot, box_pos, _const(half, pos_j), rot_j, pos_j


def _take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx[..., None])[..., 0]


def signed_point_box(p, box_rot, box_pos, half):
    """Signed distance of point p to an OBB, the outward contact normal and
    the closest surface point (world axes). Outside: the euclidean distance,
    the normal along p - closest. Inside: minus the distance to the nearest
    face (the first on a tie), that face's outward normal."""
    rt = box_rot.transpose(-1, -2)
    local = lie.mv(rt, p - box_pos)
    clamped = torch.maximum(torch.minimum(local, half), -half)
    dvec = local - clamped
    d_out = torch.linalg.norm(dvec, dim=-1)
    outside = d_out > 1e-12
    face_gap = half - torch.abs(local)  # >= 0 inside
    ax = torch.argmin(face_gap, dim=-1)
    d_in = -_take_last(face_gap, ax)
    sign = torch.sign(_take_last(local, ax))
    sign = torch.where(sign == 0, 1.0, sign)
    onehot = torch.nn.functional.one_hot(ax, 3).to(local.dtype)
    n_in_local = onehot * sign[..., None]
    surf_in_local = torch.where(onehot > 0, sign[..., None] * half, clamped)
    n_out_local = dvec / torch.clamp(d_out, min=1e-12)[..., None]
    dist = torch.where(outside, d_out, d_in)
    n_local = torch.where(outside[..., None], n_out_local, n_in_local)
    surf_local = torch.where(outside[..., None], clamped, surf_in_local)
    return dist, lie.mv(box_rot, n_local), box_pos + lie.mv(box_rot, surf_local)


def closest_point_segment_box(p0, p1, box_rot, box_pos, half, iters: int = 32):
    """argmin over t in [0, 1] of dist(p0 + t (p1 - p0), OBB) by a fixed
    ternary search (the distance to a convex set along a line is convex in
    t): static shapes, no branch on data."""
    def f(t):
        return signed_point_box(p0 + t[..., None] * (p1 - p0), box_rot, box_pos, half)[0]

    lo = torch.zeros_like(p0[..., 0])
    hi = torch.ones_like(p0[..., 0])
    for _ in range(iters):
        m1 = lo + (hi - lo) / 3.0
        m2 = hi - (hi - lo) / 3.0
        take_lo = f(m1) <= f(m2)
        lo = torch.where(take_lo, lo, m1)
        hi = torch.where(take_lo, m2, hi)
    return 0.5 * (lo + hi)


def box_box_sat(rot_a, pos_a, half_a, rot_b, pos_b, half_b):
    """OBB-OBB separating-axis test over the 15 axes (3 + 3 face normals, 9
    edge cross products). Returns (gap, n, c): the largest separation over
    the axes (the first on a tie; the penetration depth when negative), the
    normal from A towards B, and the midpoint of the two deepest support
    points."""
    t = pos_b - pos_a
    axes = [rot_a[..., :, k] for k in range(3)] + [rot_b[..., :, k] for k in range(3)]
    axes += [lie.cross(rot_a[..., :, i], rot_b[..., :, j]) for i in range(3) for j in range(3)]
    gaps, units = [], []
    for ax in axes:
        ln = torch.linalg.norm(ax, dim=-1)
        u = ax / torch.clamp(ln, min=1e-9)[..., None]
        ra = sum(half_a[k] * torch.abs(_dot(u, rot_a[..., :, k])) for k in range(3))
        rb = sum(half_b[k] * torch.abs(_dot(u, rot_b[..., :, k])) for k in range(3))
        gap = torch.abs(_dot(t, u)) - (ra + rb)
        gaps.append(torch.where(ln > 1e-9, gap, -torch.inf))
        units.append(u)
    gaps = torch.stack(gaps, dim=-1)  # (..., 15)
    units = torch.stack(units, dim=-2)  # (..., 15, 3)
    best = torch.argmax(gaps, dim=-1)
    gap = _take_last(gaps, best)
    n = torch.gather(units, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    n = torch.where((_dot(t, n) < 0)[..., None], -n, n)  # from A towards B
    # Support points: B's deepest against -n, A's deepest along +n
    sup_b = pos_b - sum(half_b[k] * torch.sign(_dot(n, rot_b[..., :, k]))[..., None]
                        * rot_b[..., :, k] for k in range(3))
    sup_a = pos_a + sum(half_a[k] * torch.sign(_dot(n, rot_a[..., :, k]))[..., None]
                        * rot_a[..., :, k] for k in range(3))
    return gap, n, 0.5 * (sup_a + sup_b)


def _point_velocity_world(kin: KinData, j, rot, pos, c):
    """World velocity of a point c fixed to joint j (kin.vel is LOCAL)."""
    w_l = kin.vel[..., j, 0:3]
    v_l = kin.vel[..., j, 3:6]
    r_l = lie.mv(rot.transpose(-1, -2), c - pos)
    return lie.mv(rot, v_l + lie.cross(w_l, r_l))


def pair_narrowphase_force(opts: ContactOptions, kin_a: KinData, ga, kin_b: KinData, gb):
    """Narrowphase and spring-damper force of one geometry pair, the two
    geometries possibly on different kinematics: capsule-capsule (exact
    segment-segment), capsule-box either way (exact point-box at the
    segment parameter of least distance), box-box (15-axis SAT).

    Returns (c, f_b, depth, (ja, rot_a, pos_a), (jb, rot_b, pos_b)): the
    world contact point, the force on body b (-f_b on body a), the signed
    gap and each body's joint placement."""
    ka, kb = _geom_kind(ga), _geom_kind(gb)
    if ka == "box" and kb == "box":
        ja, arot, apos, ahalf, rot_a, pos_a = _geom_world_box(kin_a, ga)
        jb, brot, bpos, bhalf, rot_b, pos_b = _geom_world_box(kin_b, gb)
        depth, n, c = box_box_sat(arot, apos, ahalf, brot, bpos, bhalf)
    elif "box" in (ka, kb):
        # The box on the B side; the normal flipped back after
        swap = ka == "box"
        g_cap, g_box = (gb, ga) if swap else (ga, gb)
        kin_cap, kin_box = (kin_b, kin_a) if swap else (kin_a, kin_b)
        jc, rc, c0, c1, rot_c, pos_c = _geom_world_segment(kin_cap, g_cap)
        jx, xrot, xpos, xhalf, rot_x, pos_x = _geom_world_box(kin_box, g_box)
        t = closest_point_segment_box(c0, c1, xrot, xpos, xhalf)
        p = c0 + t[..., None] * (c1 - c0)
        dist, n_pb, surf = signed_point_box(p, xrot, xpos, xhalf)
        depth = dist - rc
        # n_pb points from the box's surface to the capsule's axis point;
        # the pair's normal runs capsule -> box
        n = -n_pb
        c = surf + 0.5 * depth[..., None] * (-n_pb)
        if swap:
            (ja, rot_a, pos_a), (jb, rot_b, pos_b) = (jx, rot_x, pos_x), (jc, rot_c, pos_c)
            n = -n
        else:
            (ja, rot_a, pos_a), (jb, rot_b, pos_b) = (jc, rot_c, pos_c), (jx, rot_x, pos_x)
    else:
        ja, ra, a0, a1, rot_a, pos_a = _geom_world_segment(kin_a, ga)
        jb, rb, b0, b1, rot_b, pos_b = _geom_world_segment(kin_b, gb)
        ca, cb = closest_segment_points(a0, a1, b0, b1)
        d = cb - ca
        dist = torch.linalg.norm(d, dim=-1)
        n = d / torch.clamp(dist, min=1e-12)[..., None]  # from a towards b
        depth = dist - (ra + rb)
        c = ca + (ra + 0.5 * depth)[..., None] * n  # the overlap's midpoint
    v_rel = (_point_velocity_world(kin_b, jb, rot_b, pos_b, c)
             - _point_velocity_world(kin_a, ja, rot_a, pos_a, c))
    # The ground contact's law, the force on body b along +n when penetrating
    f_b = spring_damper_force_world(opts, n, depth, v_rel)
    return c, f_b, depth, (ja, rot_a, pos_a), (jb, rot_b, pos_b)


def add_pair_wrenches(fext: torch.Tensor, c, f_b, body_a, body_b) -> torch.Tensor:
    """`fext` with the pair's force -f_b on body a and f_b on body b, each
    at c, added as LOCAL wrenches of their joints."""
    for (j, rot_j, pos_j), sign in ((body_a, -1.0), (body_b, 1.0)):
        f_w = sign * f_b
        tau_w = lie.cross(c - pos_j, f_w)
        rt = rot_j.transpose(-1, -2)
        fext[..., j, 0:3] += lie.mv(rt, tau_w)
        fext[..., j, 3:6] += lie.mv(rt, f_w)
    return fext


def compute_pair_forces(model: RobotModel, opts: ContactOptions, kin: KinData, pairs: tuple):
    """Body-to-body spring-damper contact of geometry pairs (self-collision):
    beyond the reference, whose engine dispatches ground collision only.
    `pairs`: static ((ga, gb), ...) of `Robot.collision_pairs_geom`.

    Returns (fext (..., nj, 6) LOCAL joint wrenches, f_world (..., np, 3)
    the force on each pair's body b, depth (..., np))."""
    batch = kin.vel.shape[:-2]
    like = kin.vel
    fext = like.new_zeros(batch + (model.njoints, 6))
    if not pairs:
        return fext, like.new_zeros(batch + (0, 3)), like.new_zeros(batch + (0,))
    f_list, d_list = [], []
    for ga, gb in pairs:
        c, f_b, depth, body_a, body_b = pair_narrowphase_force(opts, kin, ga, kin, gb)
        fext = add_pair_wrenches(fext, c, f_b, body_a, body_b)
        f_list.append(f_b)
        d_list.append(depth)
    return fext, torch.stack(f_list, dim=-2), torch.stack(d_list, dim=-1)
