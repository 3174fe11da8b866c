"""Component-wise batched dynamics core (port of `jiminy_tpu.ops.cdyn`, the
spring-damper part) and the three CUDA kernels that replace its Pallas
kernels.

Plain versions. Every scalar component of every spatial quantity is its own
(B,) tensor, and the model's constants are Python floats. `ComponentDynamics`
mirrors `_accel_core` (ABA with armature, joint damping, penalty bounds and
spring-damper contact; SPHERICAL joints with their 3-dof block),
`_aux_components`, `integrate_components`, the substep and final-output
builders and the bodies of the period and rollout integrators (1-dof
joints), op for op. They are the CPU path and the reference that the
kernels are held against on the card.

Kernels (`csrc/spring.cuh`, CUDA C++ for sm_90a, built with `csrc/cdyn.cu` by
`ops/kernels.py`):

- `cdyn_accel` replaces `jiminy_tpu/ops/cdyn.py::_pallas_accel_fn` (one
  dynamics evaluation per env), with an instance for SPHERICAL joints (the
  flexibility joints, which only the per-stage path meets);
- `cdyn_period` replaces `_pallas_period_fn` (one controller period:
  n_substeps RK4/Euler substeps, then the end-of-period extras);
- `cdyn_rollout` replaces `_pallas_rollout_fn` (one whole env step: n_ticks
  x (controller, n_substeps substeps), then the extras).

What bounds them: arithmetic, once the working set stays on the chip. One
`_accel_core` evaluation of the ANYmal is about 11 k scalar operations per
env with the model's structural zeros folded (19 k generic) against about
0.29 KB of I/O, and an env step is 161 evaluations against about 0.94 KB
of I/O. All three (csrc/spring.cuh) run a group of lanes per env: the tree
passes depth after depth a joint per lane, the working set in a slice of
shared memory sized from the model (`sp_smem_per_env`, and the smaller
`accel_smem_per_env` of one evaluation), and the structural zeros of joints
whose axis is a coordinate axis dropped (`axis_class`, `spring_section`).
`cdyn_accel` (once a reset; six times a DOPRI trial) reads and writes the
caller's row-major (B, n) tensors, the other two a struct-of-arrays copy.
All read the model's constants at run time from buffers packed once per
model (`pack_model`), so one build serves every model.

Wrappers dispatch by device: a CPU tensor goes to the plain version, a CUDA
tensor to the kernel, anything else raises. There is no fallback from the
kernel to the plain version. Each wrapper counts its launches in
`KERNELS[name].launches`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from jiminy_torch.models import joints as jt
from jiminy_torch.models.model import RobotModel
from jiminy_torch.utils import terrain

# --------------------------------------------------------------------------- #
# Scalar-component linear algebra: V3 = [x, y, z], M3 = 3x3 nested list.
# Entries are tensors of the env batch shape or Python floats.
# --------------------------------------------------------------------------- #


def v3(x=0.0, y=0.0, z=0.0):
    return [x, y, z]


def v_add(a, b):
    return [a[0] + b[0], a[1] + b[1], a[2] + b[2]]


def v_sub(a, b):
    return [a[0] - b[0], a[1] - b[1], a[2] - b[2]]


def v_scale(a, s):
    return [a[0] * s, a[1] * s, a[2] * s]


def v_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def v_cross(a, b):
    return [
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ]


def m_mv(m, v):
    return [
        m[0][0] * v[0] + m[0][1] * v[1] + m[0][2] * v[2],
        m[1][0] * v[0] + m[1][1] * v[1] + m[1][2] * v[2],
        m[2][0] * v[0] + m[2][1] * v[1] + m[2][2] * v[2],
    ]


def m_tv(m, v):
    """m^T @ v"""
    return [
        m[0][0] * v[0] + m[1][0] * v[1] + m[2][0] * v[2],
        m[0][1] * v[0] + m[1][1] * v[1] + m[2][1] * v[2],
        m[0][2] * v[0] + m[1][2] * v[1] + m[2][2] * v[2],
    ]


def m_mm(a, b):
    return [[sum(a[i][k] * b[k][j] for k in range(3)) for j in range(3)] for i in range(3)]


def m_add(a, b):
    return [[a[i][j] + b[i][j] for j in range(3)] for i in range(3)]


def axis_products(axis):
    """(xx, yy, zz, xy, xz, yz) of a constant axis, as Python floats (the
    kernel reads these packed values, so both round them the same way)."""
    x, y, z = axis
    return (x * x, y * y, z * z, x * y, x * z, y * z)


def rodrigues(axis, q):
    """exp(axis * q) for a constant axis (Python float triple)."""
    c, s = torch.cos(q), torch.sin(q)
    x, y, z = axis
    xx, yy, zz, xy, xz, yz = axis_products(axis)
    one_c = 1.0 - c
    return [
        [c + xx * one_c, xy * one_c - z * s, xz * one_c + y * s],
        [xy * one_c + z * s, c + yy * one_c, yz * one_c - x * s],
        [xz * one_c - y * s, yz * one_c + x * s, c + zz * one_c],
    ]


def quat_to_m(qx, qy, qz, qw):
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return [
        [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
    ]


def sym6_from_body(mass, com, inertia_c):
    """Spatial inertia about the joint origin: [[I_O, m c^], [m c^T^, m I]]."""
    cx, cy, cz = com
    m = mass
    sc = [[0.0, -cz, cy], [cz, 0.0, -cx], [-cy, cx, 0.0]]
    scsc = [[sum(sc[i][k] * sc[k][j] for k in range(3)) for j in range(3)] for i in range(3)]
    top_left = [[inertia_c[i][j] - m * scsc[i][j] for j in range(3)] for i in range(3)]
    out = [[0.0] * 6 for _ in range(6)]
    for i in range(3):
        for j in range(3):
            out[i][j] = top_left[i][j]
            out[i][3 + j] = m * sc[i][j]
            out[3 + i][j] = m * sc[j][i]
            out[3 + i][3 + j] = m * (1.0 if i == j else 0.0)
    return out


def sym6_mv(m6, ang, lin):
    """(6x6) @ (ang, lin) -> (ang', lin')."""
    vec = [*ang, *lin]
    out = [sum(m6[i][j] * vec[j] for j in range(6)) for i in range(6)]
    return out[:3], out[3:]


def solve_sym6(m6, rhs):
    """Solve a symmetric positive definite 6x6 system by unrolled LDL^T."""
    n = 6
    l = [[0.0] * n for _ in range(n)]
    d = [0.0] * n
    for j in range(n):
        dj = m6[j][j]
        for k in range(j):
            dj = dj - l[j][k] * l[j][k] * d[k]
        d[j] = dj
        inv_dj = 1.0 / dj
        for i in range(j + 1, n):
            s = m6[i][j]
            for k in range(j):
                s = s - l[i][k] * l[j][k] * d[k]
            l[i][j] = s * inv_dj
    y = list(rhs)
    for i in range(n):
        for k in range(i):
            y[i] = y[i] - l[i][k] * y[k]
    for i in range(n):
        y[i] = y[i] / d[i]
    for i in reversed(range(n)):
        for k in range(i + 1, n):
            y[i] = y[i] - l[k][i] * y[k]
    return y


def solve_sym3(m3, rhs):
    """Solve a symmetric positive definite 3x3 system by unrolled LDL^T
    (jiminy_tpu's `solve_sym3`, the same order)."""
    n = 3
    l = [[0.0] * n for _ in range(n)]
    d = [0.0] * n
    for j in range(n):
        dj = m3[j][j]
        for k in range(j):
            dj = dj - l[j][k] * l[j][k] * d[k]
        d[j] = dj
        inv_dj = 1.0 / dj
        for i in range(j + 1, n):
            s = m3[i][j]
            for k in range(j):
                s = s - l[i][k] * l[j][k] * d[k]
            l[i][j] = s * inv_dj
    y = list(rhs)
    for i in range(n):
        for k in range(i):
            y[i] = y[i] - l[i][k] * y[k]
    for i in range(n):
        y[i] = y[i] / d[i]
    for i in reversed(range(n)):
        for k in range(i + 1, n):
            y[i] = y[i] - l[k][i] * y[k]
    return y


def _transform_sym6(ia6, rot, pos):
    """I_parent = X_F I X_M^{-1} for the placement (rot, pos) of the child in
    its parent, (ang, lin) block layout, blockwise as in jiminy_tpu."""
    a = [[ia6[i][j] for j in range(3)] for i in range(3)]
    b = [[ia6[i][3 + j] for j in range(3)] for i in range(3)]
    bt = [[ia6[3 + i][j] for j in range(3)] for i in range(3)]
    cc = [[ia6[3 + i][3 + j] for j in range(3)] for i in range(3)]
    s = [[0.0, -pos[2], pos[1]], [pos[2], 0.0, -pos[0]], [-pos[1], pos[0], 0.0]]
    r = rot
    rt = [[r[j][i] for j in range(3)] for i in range(3)]
    ra = m_mm(r, a)
    rbt = m_mm(r, bt)
    rb = m_mm(r, b)
    rc = m_mm(r, cc)
    top_l = m_add(ra, m_mm(s, rbt))
    top_r = m_add(rb, m_mm(s, rc))
    neg_rts = [[-x for x in row] for row in m_mm(rt, s)]
    out_tl = m_add(m_mm(top_l, rt), m_mm(top_r, neg_rts))
    out_tr = m_mm(top_r, rt)
    out_bl = m_add(m_mm(rbt, rt), m_mm(rc, neg_rts))
    out_br = m_mm(rc, rt)
    out = [[None] * 6 for _ in range(6)]
    for i in range(3):
        for j in range(3):
            out[i][j] = out_tl[i][j]
            out[i][3 + j] = out_tr[i][j]
            out[3 + i][j] = out_bl[i][j]
            out[3 + i][3 + j] = out_br[i][j]
    return out


def _force_transform_col(rot, pos, n, f):
    """Force (ang n, lin f) from a child joint frame to its parent's."""
    f_a = m_mv(rot, f)
    n_a = v_add(m_mv(rot, n), v_cross(pos, f_a))
    return n_a, f_a


def _motion_axis(c, j):
    """(angular, linear) motion subspace of a 1-dof joint, constant triples."""
    if c.types[j] == jt.JointType.REVOLUTE:
        return c.axis[j], (0.0, 0.0, 0.0)
    return (0.0, 0.0, 0.0), c.axis[j]


def _clip(x, lo, hi):
    """jnp.clip semantics, min(max(x, lo), hi), for tensor or float bounds."""
    return torch.clamp(torch.clamp(x, min=lo), max=hi)


_CORE_JOINTS = (jt.JointType.REVOLUTE, jt.JointType.PRISMATIC, jt.JointType.SPHERICAL)


def supports_model(model: RobotModel) -> bool:
    """True when the component core takes `model`: a FREE or fixed root and
    REVOLUTE, PRISMATIC and SPHERICAL joints (jiminy_tpu's rule). Only
    `cdyn_accel` takes SPHERICAL joints: the period and rollout integrators
    refuse them (`refuse_spherical`), as jiminy_tpu never sends them one."""
    try:
        check_model(model)
    except NotImplementedError:
        return False
    return True


def check_model(model: RobotModel) -> None:
    """Raise unless the component core supports `model`."""
    for i, t in enumerate(model.joint_types):
        t = jt.JointType(t)
        if i == 0 and t == jt.JointType.FREE:
            continue
        if t not in _CORE_JOINTS:
            raise NotImplementedError(
                f"joint {i}: {t.name} is outside the component core (free-flyer root plus "
                "REVOLUTE/PRISMATIC/SPHERICAL joints); the generic path takes it"
            )


def has_spherical(model: RobotModel) -> bool:
    return any(jt.JointType(t) == jt.JointType.SPHERICAL for t in model.joint_types)


def refuse_spherical(model: RobotModel, what: str) -> None:
    """Raise for a model with SPHERICAL joints: `what` (a period or rollout
    integrator, plain or kernel, or the constrained core) integrates a
    configuration or assembles rows for 1-dof joints only. A model with
    SPHERICAL joints comes from flexibility, which turns jiminy_tpu's fused
    period and rollout off (`jiminy_tpu/engine/engine.py:1006-1043`,
    `:1285-1288`): the engine steps it stage by stage through `cdyn_accel`,
    and in constraint contact mode on the generic path."""
    if has_spherical(model):
        raise NotImplementedError(
            f"{what} takes no SPHERICAL joint: a flexible model's fused period and rollout are "
            "off, as in jiminy_tpu; the engine steps it stage by stage through cdyn_accel"
        )


class _Consts:
    """Static per-joint constants as Python floats."""

    def __init__(self, model: RobotModel):
        self.nj = model.njoints
        self.parents = model.parents
        self.types = [jt.JointType(t) for t in model.joint_types]
        self.idx_q = model.idx_q
        self.idx_v = model.idx_v
        self.rot = [np.asarray(r, np.float64).tolist() for r in model.jplacement_rot]
        self.pos = [np.asarray(p, np.float64).tolist() for p in model.jplacement_pos]
        self.axis = [np.asarray(a, np.float64).tolist() for a in model.joint_axes]
        self.ia0 = [
            sym6_from_body(
                float(model.mass[i]),
                np.asarray(model.com[i], np.float64).tolist(),
                np.asarray(model.inertia[i], np.float64).tolist(),
            )
            for i in range(self.nj)
        ]
        self.armature = [float(x) for x in model.armature]
        self.damping = [float(x) for x in model.damping]
        self.frame_parents = model.frame_parents
        self.frot = [np.asarray(r, np.float64).tolist() for r in model.fplacement_rot]
        self.fpos = [np.asarray(p, np.float64).tolist() for p in model.fplacement_pos]


def ground_components(ground_fn, x, y):
    """(h, [nx, ny, nz]) of a ground at (x, y): its elementwise
    `height_components` (normal not normalized), else `ground_fn(xy)`."""
    cfn = getattr(ground_fn, "height_components", None)
    if cfn is not None:
        h, n = cfn(x, y)
        return h, list(n)
    h, n = ground_fn(torch.stack(torch.broadcast_tensors(x, y), dim=-1))
    return h, [n[..., 0], n[..., 1], n[..., 2]]


class ComponentDynamics:
    """Fused spring-damper forward dynamics for one robot model.

    `accel(q, v, tau)`: (..., nq), (..., nv), (..., nv) -> (..., nv), the
    ABA of the model with armature, joint damping, penalty joint bounds and
    spring-damper contact on the ground `ground_fn` (None: flat, z = 0). A
    ground's height and normal come from its `height_components` (the
    kernels evaluate its packed form, `utils.terrain.pack_ground`), else from
    `ground_fn(xy)` (the CPU only).
    """

    def __init__(
        self,
        model: RobotModel,
        gravity,
        contact_opts=None,
        contact_frames: tuple = (),
        contact_radii: tuple = (),
        bound_gains: Optional[dict] = None,
        ground_fn=None,
    ):
        check_model(model)
        self.model = model
        self.c = _Consts(model)
        self.gravity = tuple(float(g) for g in np.asarray(gravity))
        self.contact_opts = contact_opts
        self.contact_frames = tuple(contact_frames)
        self.contact_radii = tuple(float(r) for r in contact_radii) or (0.0,) * len(
            self.contact_frames
        )
        # The ground profile (`utils.terrain`; None: flat ground z = 0)
        self.ground_fn = ground_fn
        # Penalty bounds: {vidx: (lo, hi, kp, kd, qidx)}
        self.bound_gains = {
            int(k): tuple(float(x) for x in val[:4]) + (int(val[4]),)
            for k, val in (bound_gains or {}).items()
        }
        self._packed = {}

    @property
    def has_contacts(self) -> bool:
        return bool(self.contact_frames) and self.contact_opts is not None

    # ---------------- kinematics ----------------
    def _joint_x(self, qc):
        """Per-joint placement in the parent joint frame: (M3, V3) lists."""
        c = self.c
        xs = []
        for i in range(c.nj):
            tree_r, tree_p = c.rot[i], c.pos[i]
            qi = c.idx_q[i]
            if c.types[i] == jt.JointType.FREE:
                rot_j = quat_to_m(qc[qi + 3], qc[qi + 4], qc[qi + 5], qc[qi + 6])
                pos_j = [qc[qi], qc[qi + 1], qc[qi + 2]]
                rot = m_mm(tree_r, rot_j)
                pos = v_add(m_mv(tree_r, pos_j), tree_p)
            elif c.types[i] == jt.JointType.SPHERICAL:
                rot = m_mm(tree_r, quat_to_m(qc[qi], qc[qi + 1], qc[qi + 2], qc[qi + 3]))
                pos = tree_p
            elif c.types[i] == jt.JointType.REVOLUTE:
                rot = m_mm(tree_r, rodrigues(c.axis[i], qc[qi]))
                pos = tree_p
            else:  # PRISMATIC
                rot = tree_r
                pos = v_add(m_mv(tree_r, v_scale(c.axis[i], qc[qi])), tree_p)
            xs.append((rot, pos))
        return xs

    def _world_placements(self, xs):
        c = self.c
        world = []
        for i in range(c.nj):
            rot_i, pos_i = xs[i]
            p = c.parents[i]
            if p < 0:
                world.append((rot_i, pos_i))
            else:
                rw, pw = world[p]
                world.append((m_mm(rw, rot_i), v_add(m_mv(rw, pos_i), pw)))
        return world

    # ---------------- contact ----------------
    def _contact_fext(self, world, vel, want_aux: bool = False):
        """Spring-damper ground forces -> per-joint LOCAL wrenches, world
        forces per contact and, with `want_aux`, per-contact (depth, LOCAL
        contact-frame wrench [n(3), f(3)])."""
        c = self.c
        opts = self.contact_opts
        fext = [None] * c.nj
        f_world_all = []
        aux_all = []
        for fidx, radius in zip(self.contact_frames, self.contact_radii):
            parent = c.frame_parents[fidx]
            fp = c.fpos[fidx]
            rw, pw = world[parent]
            pc = v_add(m_mv(rw, fp), pw)
            w_l, v_l = vel[parent]
            v_w = m_mv(rw, v_add(v_l, v_cross(w_l, fp)))
            if self.ground_fn is None:
                n = [0.0, 0.0, 1.0]
                depth = pc[2]
                v_depth = v_w[2]
            else:
                h, n = ground_components(self.ground_fn, pc[0], pc[1])
                nn = torch.sqrt(torch.clamp(v_dot(n, n), min=1e-24))
                n = v_scale(n, 1.0 / nn)
                depth = (pc[2] - h) * n[2]
                v_depth = v_dot(v_w, n)
            d_off = None
            if radius > 0.0:
                depth = depth - radius
                d_off = v_scale(n, -radius)
                v_w = v_add(v_w, v_cross(m_mv(rw, w_l), d_off))
                v_depth = v_dot(v_w, n)
            f_normal = -torch.clamp(opts.stiffness * depth + opts.damping * v_depth, max=0.0)
            fw = v_scale(n, f_normal)
            v_tang = v_sub(v_w, v_scale(n, v_depth))
            v_norm = torch.sqrt(torch.clamp(v_dot(v_tang, v_tang), min=1e-24))
            v_ratio = torch.clamp(v_norm / opts.transition_velocity, max=1.0)
            scale_t = opts.friction * v_ratio * f_normal / v_norm
            fw = v_sub(fw, v_scale(v_tang, scale_t))
            if opts.transition_eps > 1e-12:
                blend = torch.tanh(2.0 * (-depth) / opts.transition_eps)
                fw = v_scale(fw, blend)
            active = depth < 0.0
            fw = [torch.where(active, comp, 0.0) for comp in fw]
            f_world_all.append(fw)
            lever = v_sub(pc, pw)
            if d_off is not None:
                lever = v_add(lever, d_off)
            f_j = m_tv(rw, fw)
            n_j = m_tv(rw, v_cross(lever, fw))
            if want_aux:
                frot = c.frot[fidx]
                f_local = m_tv(frot, f_j)
                if d_off is not None:
                    n_local = m_tv(frot, m_tv(rw, v_cross(d_off, fw)))
                else:
                    n_local = [torch.zeros_like(f_local[0])] * 3
                aux_all.append((depth, [*n_local, *f_local]))
            if fext[parent] is None:
                fext[parent] = (n_j, f_j)
            else:
                pa, pl = fext[parent]
                fext[parent] = (v_add(pa, n_j), v_add(pl, f_j))
        return fext, f_world_all, aux_all

    # ---------------- the dynamics core ----------------
    def _accel_core(self, qc, vc, tc):
        """Component-level forward dynamics: lists in, (qdd list, f_world) out."""
        c = self.c
        tc = [
            tc[i] - c.damping[i] * vc[i] if c.damping[i] != 0.0 else tc[i]
            for i in range(len(tc))
        ]
        xs = self._joint_x(qc)

        # Pass 1: velocities, bias, body articulated inertia, bias force
        vel = [None] * c.nj
        bias = [None] * c.nj
        ia = [None] * c.nj
        pa = [None] * c.nj
        svec = [None] * c.nj
        for i in range(c.nj):
            rot_i, pos_i = xs[i]
            p = c.parents[i]
            w_p, v_p = (v3(), v3()) if p < 0 else vel[p]
            w_in = m_tv(rot_i, w_p)
            v_in = m_tv(rot_i, v_sub(v_p, v_cross(pos_i, w_p)))
            vi = c.idx_v[i]
            if c.types[i] == jt.JointType.FREE:
                vj_lin = [vc[vi], vc[vi + 1], vc[vi + 2]]
                vj_ang = [vc[vi + 3], vc[vi + 4], vc[vi + 5]]
            elif c.types[i] == jt.JointType.SPHERICAL:
                vj_ang = [vc[vi], vc[vi + 1], vc[vi + 2]]
                vj_lin = v3()
            else:
                ax = c.axis[i]
                if c.types[i] == jt.JointType.REVOLUTE:
                    vj_ang, vj_lin = v_scale(ax, vc[vi]), v3()
                    svec[i] = (ax, (0.0, 0.0, 0.0))
                else:
                    vj_ang, vj_lin = v3(), v_scale(ax, vc[vi])
                    svec[i] = ((0.0, 0.0, 0.0), ax)
            w_i = v_add(w_in, vj_ang)
            v_i = v_add(v_in, vj_lin)
            vel[i] = (w_i, v_i)
            bias[i] = (
                v_cross(w_i, vj_ang),
                v_add(v_cross(w_i, vj_lin), v_cross(v_i, vj_ang)),
            )
            ia[i] = [list(row) for row in c.ia0[i]]
            iv_a, iv_l = sym6_mv(ia[i], w_i, v_i)
            pa[i] = (
                v_add(v_cross(w_i, iv_a), v_cross(v_i, iv_l)),
                v_cross(w_i, iv_l),
            )

        f_world_all = []
        if self.has_contacts:
            world = self._world_placements(xs)
            fext, f_world_all, _ = self._contact_fext(world, vel)
            for i in range(c.nj):
                if fext[i] is not None:
                    pa_a, pa_l = pa[i]
                    pa[i] = (v_sub(pa_a, fext[i][0]), v_sub(pa_l, fext[i][1]))

        # Stable penalty joint bounds
        tau_extra = {}
        for vi, (lo, hi, kp, kd, qi) in self.bound_gains.items():
            over = torch.clamp(qc[qi] - hi, min=0.0)
            under = torch.clamp(lo - qc[qi], min=0.0)
            active = (over > 0.0) | (under > 0.0)
            tau_extra[vi] = kp * (under - over) - torch.where(active, kd * vc[vi], 0.0)

        # Pass 2: articulated inertia, inward
        u_of = [None] * c.nj
        d_inv = [None] * c.nj
        u_rhs = [None] * c.nj
        ia_root = None
        for i in reversed(range(c.nj)):
            rot_i, pos_i = xs[i]
            p = c.parents[i]
            if c.types[i] == jt.JointType.FREE:
                ia_root = ia[i]
                continue
            vi = c.idx_v[i]
            pa6 = [*pa[i][0], *pa[i][1]]
            if c.types[i] == jt.JointType.SPHERICAL:
                # 3-dof angular subspace: U = IA[:, 0:3], D = IA[0:3, 0:3] + armature
                u63 = [[ia[i][r][k] for k in range(3)] for r in range(6)]
                dmat = [[ia[i][r][k] for k in range(3)] for r in range(3)]
                for k in range(3):
                    dmat[k][k] = dmat[k][k] + c.armature[vi + k]
                u_r3 = [tc[vi + k] + tau_extra.get(vi + k, 0.0) - pa[i][0][k] for k in range(3)]
                u_of[i], d_inv[i], u_rhs[i] = u63, dmat, u_r3
                if p >= 0:
                    # Ia = IA - U D^-1 U^T, a column of D^-1 U^T a solve
                    xcols = [solve_sym3(dmat, list(u63[c6])) for c6 in range(6)]
                    ia_a = [[ia[i][r][c6] - sum(u63[r][k] * xcols[c6][k] for k in range(3))
                             for c6 in range(6)] for r in range(6)]
                    iab_a, iab_l = sym6_mv(ia_a, *bias[i])
                    iab = [*iab_a, *iab_l]
                    coef3 = solve_sym3(dmat, u_r3)
                    pa_n = [pa6[k6] + iab[k6] + sum(u63[k6][k] * coef3[k] for k in range(3))
                            for k6 in range(6)]
                    ia_p = _transform_sym6(ia_a, rot_i, pos_i)
                    for r in range(6):
                        for col in range(6):
                            ia[p][r][col] = ia[p][r][col] + ia_p[r][col]
                    f_a = m_mv(rot_i, pa_n[3:])
                    n_a = v_add(m_mv(rot_i, pa_n[:3]), v_cross(pos_i, f_a))
                    pp_a, pp_l = pa[p]
                    pa[p] = (v_add(pp_a, n_a), v_add(pp_l, f_a))
                continue
            ax_a, ax_l = svec[i]
            s6 = [*ax_a, *ax_l]
            ua, ul = sym6_mv(ia[i], list(ax_a), list(ax_l))
            u6 = [*ua, *ul]
            dinv = 1.0 / (sum(s6[k] * u6[k] for k in range(6)) + c.armature[vi])
            u_r = tc[vi] + tau_extra.get(vi, 0.0) - sum(s6[k] * pa6[k] for k in range(6))
            u_of[i], d_inv[i], u_rhs[i] = u6, dinv, u_r
            if p >= 0:
                ia_a = [[ia[i][r][col] - u6[r] * u6[col] * dinv for col in range(6)] for r in range(6)]
                iab_a, iab_l = sym6_mv(ia_a, *bias[i])
                iab = [*iab_a, *iab_l]
                coef = u_r * dinv
                pa_n = [pa6[k] + iab[k] + u6[k] * coef for k in range(6)]
                ia_p = _transform_sym6(ia_a, rot_i, pos_i)
                for r in range(6):
                    for col in range(6):
                        ia[p][r][col] = ia[p][r][col] + ia_p[r][col]
                f_a = m_mv(rot_i, pa_n[3:])
                n_a = v_add(m_mv(rot_i, pa_n[:3]), v_cross(pos_i, f_a))
                pp_a, pp_l = pa[p]
                pa[p] = (v_add(pp_a, n_a), v_add(pp_l, f_a))

        # Pass 3: outward accelerations (-gravity trick at the root)
        g = self.gravity
        a0 = ([0.0, 0.0, 0.0], [-g[0], -g[1], -g[2]])
        acc = [None] * c.nj
        qdd_parts = {}
        for i in range(c.nj):
            rot_i, pos_i = xs[i]
            p = c.parents[i]
            a_p = acc[p] if p >= 0 else a0
            aw_in = m_tv(rot_i, a_p[0])
            al_in = m_tv(rot_i, v_sub(a_p[1], v_cross(pos_i, a_p[0])))
            am_a = v_add(aw_in, bias[i][0])
            am_l = v_add(al_in, bias[i][1])
            vi = c.idx_v[i]
            if c.types[i] == jt.JointType.FREE:
                m6 = [[ia_root[(r + 3) % 6][(col + 3) % 6] for col in range(6)] for r in range(6)]
                for k in range(6):
                    m6[k][k] = m6[k][k] + c.armature[vi + k]
                pa_a, pa_l = pa[i]
                iam_a, iam_l = sym6_mv(ia_root, am_a, am_l)
                rhs = [
                    tc[vi + 0] - pa_l[0] - iam_l[0],
                    tc[vi + 1] - pa_l[1] - iam_l[1],
                    tc[vi + 2] - pa_l[2] - iam_l[2],
                    tc[vi + 3] - pa_a[0] - iam_a[0],
                    tc[vi + 4] - pa_a[1] - iam_a[1],
                    tc[vi + 5] - pa_a[2] - iam_a[2],
                ]
                qdd6 = solve_sym6(m6, rhs)
                for k in range(6):
                    qdd_parts[vi + k] = qdd6[k]
                acc[i] = (v_add(am_a, qdd6[3:6]), v_add(am_l, qdd6[0:3]))
            elif c.types[i] == jt.JointType.SPHERICAL:
                u63 = u_of[i]
                am6 = [*am_a, *am_l]
                rhs3 = [u_rhs[i][k] - sum(u63[k6][k] * am6[k6] for k6 in range(6))
                        for k in range(3)]
                qdd3 = solve_sym3(d_inv[i], rhs3)
                for k in range(3):
                    qdd_parts[vi + k] = qdd3[k]
                acc[i] = (v_add(am_a, qdd3), list(am_l))
            else:
                u6 = u_of[i]
                am6 = [*am_a, *am_l]
                qdd = d_inv[i] * (u_rhs[i] - sum(u6[k] * am6[k] for k in range(6)))
                qdd_parts[vi] = qdd
                ax_a, ax_l = svec[i]
                acc[i] = (
                    v_add(am_a, v_scale(list(ax_a), qdd)),
                    v_add(am_l, v_scale(list(ax_l), qdd)),
                )
        return [qdd_parts[k] for k in range(self.model.nv)], f_world_all

    # ---------------- post-step auxiliary outputs ----------------
    def _fk_accel_components(self, xs, vc, ac):
        """Velocity and gravity-free acceleration recursion given the solved
        joint accelerations."""
        c = self.c
        vel = [None] * c.nj
        acc = [None] * c.nj
        for i in range(c.nj):
            rot_i, pos_i = xs[i]
            p = c.parents[i]
            w_p, v_p = vel[p] if p >= 0 else (v3(), v3())
            a_p = acc[p] if p >= 0 else (v3(), v3())
            w_in = m_tv(rot_i, w_p)
            v_in = m_tv(rot_i, v_sub(v_p, v_cross(pos_i, w_p)))
            aw_in = m_tv(rot_i, a_p[0])
            al_in = m_tv(rot_i, v_sub(a_p[1], v_cross(pos_i, a_p[0])))
            vi = c.idx_v[i]
            if c.types[i] == jt.JointType.FREE:
                vj_lin = [vc[vi], vc[vi + 1], vc[vi + 2]]
                vj_ang = [vc[vi + 3], vc[vi + 4], vc[vi + 5]]
                aj_lin = [ac[vi], ac[vi + 1], ac[vi + 2]]
                aj_ang = [ac[vi + 3], ac[vi + 4], ac[vi + 5]]
            elif c.types[i] == jt.JointType.SPHERICAL:
                vj_ang, vj_lin = [vc[vi], vc[vi + 1], vc[vi + 2]], v3()
                aj_ang, aj_lin = [ac[vi], ac[vi + 1], ac[vi + 2]], v3()
            elif c.types[i] == jt.JointType.REVOLUTE:
                vj_ang, vj_lin = v_scale(c.axis[i], vc[vi]), v3()
                aj_ang, aj_lin = v_scale(c.axis[i], ac[vi]), v3()
            else:  # PRISMATIC
                vj_ang, vj_lin = v3(), v_scale(c.axis[i], vc[vi])
                aj_ang, aj_lin = v3(), v_scale(c.axis[i], ac[vi])
            w_i = v_add(w_in, vj_ang)
            v_i = v_add(v_in, vj_lin)
            vel[i] = (w_i, v_i)
            b_ang = v_cross(w_i, vj_ang)
            b_lin = v_add(v_cross(w_i, vj_lin), v_cross(v_i, vj_ang))
            acc[i] = (
                v_add(v_add(aw_in, aj_ang), b_ang),
                v_add(v_add(al_in, aj_lin), b_lin),
            )
        return vel, acc

    def _aux_components(self, qc, vc, ac, imu_frames: tuple = ()):
        """(f_world rows, w_local rows, depth list, imu rows) given solved
        accelerations; every row is a list of components."""
        c = self.c
        xs = self._joint_x(qc)
        world = self._world_placements(xs)
        vel, acc = self._fk_accel_components(xs, vc, ac)
        if self.has_contacts:
            _, f_world_all, aux_all = self._contact_fext(world, vel, want_aux=True)
            w_local_all = [w for _, w in aux_all]
            depth_all = [d for d, _ in aux_all]
        else:
            f_world_all, w_local_all, depth_all = [], [], []
        imu_rows = []
        g = self.gravity
        for fidx in imu_frames:
            parent = c.frame_parents[fidx]
            frot, fp = c.frot[fidx], c.fpos[fidx]
            w_l, v_l = vel[parent]
            a_a, a_l = acc[parent]
            w_f = m_tv(frot, w_l)
            v_f = m_tv(frot, v_sub(v_l, v_cross(fp, w_l)))
            al_f = m_tv(frot, v_sub(a_l, v_cross(fp, a_a)))
            acc_cl = v_add(al_f, v_cross(w_f, v_f))
            rot_f = m_mm(world[parent][0], frot)
            g_f = m_tv(rot_f, [g[0], g[1], g[2]])
            imu_rows.append([*w_f, *v_sub(acc_cl, g_f)])
        return f_world_all, w_local_all, depth_all, imu_rows

    def aux_outputs(self, q, v, a, imu_frames: tuple = ()) -> dict:
        """Contact forces (world force, LOCAL contact-frame wrench, signed
        depth) and raw IMU measurements, plain torch on any device: it runs
        outside the kernels, as in jiminy_tpu (`Engine._final_eval`).

        Returns contact_f_world (..., nc, 3), contact_w_local (..., nc, 6),
        contact_depth (..., nc), imu_raw (..., n_imu, 6)."""
        model = self.model
        qc = [q[..., i] for i in range(model.nq)]
        vc = [v[..., i] for i in range(model.nv)]
        ac = [a[..., i] for i in range(model.nv)]
        batch = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1], a.shape[:-1])
        fw, wl, depth, imu = self._aux_components(qc, vc, ac, imu_frames)

        def stack_rows(rows, width):
            if not rows:
                return q.new_zeros(batch + (0, width))
            return torch.stack([_stack(r, batch, q) for r in rows], dim=-2)

        return {
            "contact_f_world": stack_rows(fw, 3),
            "contact_w_local": stack_rows(wl, 6),
            "contact_depth": _stack(depth, batch, q),
            "imu_raw": stack_rows(imu, 6),
        }

    # ---------------- component Lie-group integration ----------------
    @staticmethod
    def _exp3_quat_c(w):
        """so(3) -> quaternion components [x, y, z, w] (lie.exp3 thresholds)."""
        theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
        eps = float(torch.finfo(theta2.dtype).eps)
        theta = torch.sqrt(torch.clamp(theta2, min=eps * eps))
        small = theta2 < 1e-6
        s_over = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(0.5 * theta) / theta)
        c = torch.where(
            small, 1.0 - theta2 / 8.0 + theta2 * theta2 / 384.0, torch.cos(0.5 * theta)
        )
        return [w[0] * s_over, w[1] * s_over, w[2] * s_over, c]

    @staticmethod
    def _vmat_mv_c(w, vl):
        """V(omega) @ v of the SE(3) exponential."""
        theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
        eps = float(torch.finfo(theta2.dtype).eps)
        theta = torch.sqrt(torch.clamp(theta2, min=eps * eps))
        small = theta2 < 1e-6
        b = torch.where(
            small,
            0.5 - theta2 / 24.0,
            (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-30),
        )
        c = torch.where(
            small,
            1.0 / 6.0 - theta2 / 120.0,
            (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=1e-30),
        )
        wxv = v_cross(w, vl)
        wxwxv = v_cross(w, wxv)
        return [vl[k] + b * wxv[k] + c * wxwxv[k] for k in range(3)]

    @staticmethod
    def _quat_mul_c(q1, q2):
        x1, y1, z1, w1 = q1
        x2, y2, z2, w2 = q2
        return [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ]

    @staticmethod
    def _quat_normalize_c(q):
        n = torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
        return [q[0] / n, q[1] / n, q[2] / n, q[3] / n]

    def integrate_components(self, qc, dvc):
        """Configuration retraction q (+) dv, component-wise."""
        c = self.c
        out = list(qc)
        for i in range(c.nj):
            qi, vi = c.idx_q[i], c.idx_v[i]
            if c.types[i] == jt.JointType.FREE:
                p = [qc[qi], qc[qi + 1], qc[qi + 2]]
                quat = [qc[qi + 3], qc[qi + 4], qc[qi + 5], qc[qi + 6]]
                vlin = [dvc[vi], dvc[vi + 1], dvc[vi + 2]]
                om = [dvc[vi + 3], dvc[vi + 4], dvc[vi + 5]]
                p_d = self._vmat_mv_c(om, vlin)
                rot = quat_to_m(*quat)
                out[qi : qi + 3] = v_add(p, m_mv(rot, p_d))
                out[qi + 3 : qi + 7] = self._quat_normalize_c(
                    self._quat_mul_c(quat, self._exp3_quat_c(om))
                )
            else:
                out[qi] = qc[qi] + dvc[vi]
        return out

    # ---------------- CRBA + RNEA (nle): the constrained path ----------------
    def mass_matrix_components(self, qc, xs=None):
        """CRBA with armature: nv x nv nested list of tensors (Python 0.0
        where two dofs share no ancestor line)."""
        c = self.c
        nv = self.model.nv
        if xs is None:
            xs = self._joint_x(qc)
        ic = [[list(row) for row in c.ia0[i]] for i in range(c.nj)]
        m_out = [[0.0] * nv for _ in range(nv)]

        def vel_perm(k):  # free-joint vel index -> motion index
            return (k + 3) % 6

        def ancestor_fill(i, vi_row, n_c, f_c):
            """Transport one force column up the tree, filling M[vi_row, :]."""
            j = i
            while c.parents[j] >= 0:
                rot_j, pos_j = xs[j]
                n_c, f_c = _force_transform_col(rot_j, pos_j, n_c, f_c)
                j = c.parents[j]
                vj = c.idx_v[j]
                if c.types[j] == jt.JointType.FREE:
                    full = [*n_c, *f_c]
                    for k in range(6):
                        val = full[vel_perm(k)]
                        m_out[vi_row][vj + k] = val
                        m_out[vj + k][vi_row] = val
                else:
                    axj_a, axj_l = _motion_axis(c, j)
                    val = sum(axj_a[k] * n_c[k] for k in range(3)) + sum(
                        axj_l[k] * f_c[k] for k in range(3)
                    )
                    m_out[vi_row][vj] = val
                    m_out[vj][vi_row] = val

        for i in reversed(range(c.nj)):
            vi = c.idx_v[i]
            if c.types[i] == jt.JointType.FREE:
                # Diagonal block = permuted composite inertia + armature
                for r in range(6):
                    for col in range(6):
                        m_out[vi + r][vi + col] = ic[i][vel_perm(r)][vel_perm(col)]
                    m_out[vi + r][vi + r] = m_out[vi + r][vi + r] + c.armature[vi + r]
                continue  # the free root has no ancestors
            ax_a, ax_l = _motion_axis(c, i)
            fa, fl = sym6_mv(ic[i], list(ax_a), list(ax_l))
            m_out[vi][vi] = (
                sum(ax_a[k] * fa[k] for k in range(3))
                + sum(ax_l[k] * fl[k] for k in range(3))
                + c.armature[vi]
            )
            ancestor_fill(i, vi, fa, fl)
            p = c.parents[i]
            if p >= 0:  # composite inertia into the parent
                rot_i, pos_i = xs[i]
                ia_p = _transform_sym6(ic[i], rot_i, pos_i)
                for r in range(6):
                    for col in range(6):
                        ic[p][r][col] = ic[p][r][col] + ia_p[r][col]
        return m_out

    def nle_components(self, qc, vc, xs=None, fext=None):
        """Nonlinear effects (gravity + Coriolis/centrifugal) as nv
        components: RNEA with zero joint acceleration. `fext`: per-joint
        LOCAL wrenches [(ang V3, lin V3) or None] (`_contact_fext`), taken
        off each joint's force."""
        c = self.c
        g = self.gravity
        if xs is None:
            xs = self._joint_x(qc)
        vel = [None] * c.nj
        acc = [None] * c.nj
        f = [None] * c.nj
        svec = [None] * c.nj
        a0 = ([0.0, 0.0, 0.0], [-g[0], -g[1], -g[2]])
        for i in range(c.nj):
            rot_i, pos_i = xs[i]
            p = c.parents[i]
            w_p, v_p = vel[p] if p >= 0 else (v3(), v3())
            a_p = acc[p] if p >= 0 else a0
            w_in = m_tv(rot_i, w_p)
            v_in = m_tv(rot_i, v_sub(v_p, v_cross(pos_i, w_p)))
            aw_in = m_tv(rot_i, a_p[0])
            al_in = m_tv(rot_i, v_sub(a_p[1], v_cross(pos_i, a_p[0])))
            vi = c.idx_v[i]
            if c.types[i] == jt.JointType.FREE:
                vj_lin = [vc[vi], vc[vi + 1], vc[vi + 2]]
                vj_ang = [vc[vi + 3], vc[vi + 4], vc[vi + 5]]
            elif c.types[i] == jt.JointType.REVOLUTE:
                vj_ang, vj_lin = v_scale(c.axis[i], vc[vi]), v3()
            else:
                vj_ang, vj_lin = v3(), v_scale(c.axis[i], vc[vi])
            if c.types[i] != jt.JointType.FREE:
                svec[i] = _motion_axis(c, i)
            w_i = v_add(w_in, vj_ang)
            v_i = v_add(v_in, vj_lin)
            vel[i] = (w_i, v_i)
            b_ang = v_cross(w_i, vj_ang)
            b_lin = v_add(v_cross(w_i, vj_lin), v_cross(v_i, vj_ang))
            acc[i] = (v_add(aw_in, b_ang), v_add(al_in, b_lin))

        tau = [0.0] * self.model.nv
        for i in reversed(range(c.nj)):
            ia = c.ia0[i]
            a_a, a_l = acc[i]
            w_i, v_i = vel[i]
            ia_a, ia_l = sym6_mv(ia, a_a, a_l)
            iv_a, iv_l = sym6_mv(ia, w_i, v_i)
            f_a = v_add(ia_a, v_add(v_cross(w_i, iv_a), v_cross(v_i, iv_l)))
            f_l = v_add(ia_l, v_cross(w_i, iv_l))
            if fext is not None and fext[i] is not None:
                f_a = v_sub(f_a, fext[i][0])
                f_l = v_sub(f_l, fext[i][1])
            if f[i] is not None:
                f_a = v_add(f_a, f[i][0])
                f_l = v_add(f_l, f[i][1])
            vi = c.idx_v[i]
            if c.types[i] == jt.JointType.FREE:
                full = [*f_a, *f_l]
                for k in range(6):
                    tau[vi + k] = full[(k + 3) % 6]
            else:
                ax_a, ax_l = svec[i]
                tau[vi] = sum(ax_a[k] * f_a[k] for k in range(3)) + sum(
                    ax_l[k] * f_l[k] for k in range(3)
                )
            p = c.parents[i]
            if p >= 0:
                rot_i, pos_i = xs[i]
                n_p, f_p = _force_transform_col(rot_i, pos_i, f_a, f_l)
                if f[p] is None:
                    f[p] = (n_p, f_p)
                else:
                    f[p] = (v_add(f[p][0], n_p), v_add(f[p][1], f_p))
        return tau

    # ---------------- constraint kinematics ----------------
    def _vel_bias_components(self, xs, vc):
        """Per-joint LOCAL velocity and velocity-bias acceleration (FK with
        zero joint acceleration, no gravity)."""
        c = self.c
        vel = [None] * c.nj
        acc = [None] * c.nj
        for i in range(c.nj):
            rot_i, pos_i = xs[i]
            p = c.parents[i]
            w_p, v_p = vel[p] if p >= 0 else (v3(), v3())
            a_p = acc[p] if p >= 0 else (v3(), v3())
            w_in = m_tv(rot_i, w_p)
            v_in = m_tv(rot_i, v_sub(v_p, v_cross(pos_i, w_p)))
            aw_in = m_tv(rot_i, a_p[0])
            al_in = m_tv(rot_i, v_sub(a_p[1], v_cross(pos_i, a_p[0])))
            vi = c.idx_v[i]
            if c.types[i] == jt.JointType.FREE:
                vj_lin = [vc[vi], vc[vi + 1], vc[vi + 2]]
                vj_ang = [vc[vi + 3], vc[vi + 4], vc[vi + 5]]
            elif c.types[i] == jt.JointType.REVOLUTE:
                vj_ang, vj_lin = v_scale(c.axis[i], vc[vi]), v3()
            else:
                vj_ang, vj_lin = v3(), v_scale(c.axis[i], vc[vi])
            w_i = v_add(w_in, vj_ang)
            v_i = v_add(v_in, vj_lin)
            vel[i] = (w_i, v_i)
            b_ang = v_cross(w_i, vj_ang)
            b_lin = v_add(v_cross(w_i, vj_lin), v_cross(v_i, vj_ang))
            acc[i] = (v_add(aw_in, b_ang), v_add(al_in, b_lin))
        return vel, acc

    def _ancestors(self, joint):
        out = []
        j = joint
        while j >= 0:
            out.append(j)
            j = self.c.parents[j]
        return out[::-1]

    def _point_jacobian_cols(self, world, joint, pf):
        """World-aligned LINEAR Jacobian columns {vdof: V3} of the point `pf`
        (world V3 components) attached to `joint`'s subtree."""
        return self._frame_jacobian_cols(world, joint, pf)[1]

    def _frame_jacobian_cols(self, world, joint, pf):
        """World-aligned frame Jacobian columns at the point `pf`:
        `(ang_cols, lin_cols)`, each a {vdof: V3} dict over the dofs of the
        joint's ancestors (the support dofs of a contact row)."""
        c = self.c
        ang, lin = {}, {}
        for j in self._ancestors(joint):
            rw, pw = world[j]
            vi = c.idx_v[j]
            if c.types[j] == jt.JointType.FREE:
                for k in range(3):  # translational dofs
                    lin[vi + k] = [rw[0][k], rw[1][k], rw[2][k]]
                    ang[vi + k] = v3()
                for k in range(3):  # rotational dofs
                    axis_w = [rw[0][k], rw[1][k], rw[2][k]]
                    ang[vi + 3 + k] = axis_w
                    lin[vi + 3 + k] = v_cross(axis_w, v_sub(pf, pw))
            elif c.types[j] == jt.JointType.REVOLUTE:
                axis_w = m_mv(rw, c.axis[j])
                ang[vi] = axis_w
                lin[vi] = v_cross(axis_w, v_sub(pf, pw))
            else:  # PRISMATIC
                ang[vi] = v3()
                lin[vi] = m_mv(rw, c.axis[j])
        return ang, lin

    def distance_rows_components(self, world, vel, acc, pairs, dist_ref, kp: float, kd: float):
        """The loop closures' rows and Baumgarte drifts: each row the two
        frames' point Jacobians over their support dofs projected on the
        unit direction between them, its drift `dir.(a_a - a_b) + (|dv|^2 -
        (dv.dir)^2) / dist + kp (dist - ref) + kd dv.dir`. Returns (rows
        [nd][nv components, Python 0.0 off the supports], drifts [nd])."""
        c = self.c
        nv = self.model.nv
        rows, drifts = [], []
        for k, (fa, fb) in enumerate(pairs):
            data = []
            for fidx in (fa, fb):
                parent = c.frame_parents[fidx]
                fp = c.fpos[fidx]
                rw, pw = world[parent]
                p_f = v_add(m_mv(rw, fp), pw)
                w_l, v_l = vel[parent]
                a_l = acc[parent]
                vw_lin = m_mv(rw, v_add(v_l, v_cross(w_l, fp)))
                vw_ang = m_mv(rw, w_l)
                aw_lin = v_add(m_mv(rw, v_sub(a_l[1], v_cross(fp, a_l[0]))),
                               v_cross(vw_ang, vw_lin))
                data.append((parent, p_f, vw_lin, aw_lin))
            (ja, pa, va, aa), (jb, pb, vb, ab) = data
            dp = v_sub(pa, pb)
            dist = torch.sqrt(torch.clamp(v_dot(dp, dp), min=1e-24))
            direction = v_scale(dp, 1.0 / dist)
            row = [0.0] * nv
            for d, col in self._point_jacobian_cols(world, ja, pa).items():
                row[d] = row[d] + v_dot(direction, col)
            for d, col in self._point_jacobian_cols(world, jb, pb).items():
                row[d] = row[d] - v_dot(direction, col)
            dv = v_sub(va, vb)
            dv_proj = v_dot(dv, direction)
            g = v_dot(direction, v_sub(aa, ab))
            g = g + (v_dot(dv, dv) - dv_proj * dv_proj) / dist
            g = g + kp * (dist - dist_ref[k]) + kd * dv_proj
            rows.append(row)
            drifts.append(g)
        return rows, drifts

    # ---------------- fused multi-substep integration ----------------
    def _build_final_outputs(self, tau_c_fn, imu_frames):
        """End-of-period solved accel and aux outputs as one component list:
        `[a (nv) | f_world (nc*3) | w_local (nc*6) | depth (nc) | imu (ni*6)]`."""

        def final_outputs(qc, vc, cc):
            ac = self._accel_core(qc, vc, tau_c_fn(qc, vc, cc))[0]
            fw, wl, depth, imu = self._aux_components(qc, vc, ac, imu_frames)
            extras = list(ac)
            for r in fw:
                extras.extend(r)
            for r in wl:
                extras.extend(r)
            extras.extend(depth)
            for r in imu:
                extras.extend(r)
            return extras

        return final_outputs

    def _build_substep(self, tau_c_fn, dt: float, integrator: str):
        """One fixed-dt integration substep, component lists in and out."""
        nv = self.model.nv

        def substep(qc, vc, cc):
            k1a = self._accel_core(qc, vc, tau_c_fn(qc, vc, cc))[0]
            if integrator == "euler":
                q_n = self.integrate_components(qc, [dt * x for x in vc])
                return q_n, [vc[k] + dt * k1a[k] for k in range(nv)]
            q2 = self.integrate_components(qc, [0.5 * dt * x for x in vc])
            v2 = [vc[k] + 0.5 * dt * k1a[k] for k in range(nv)]
            k2a = self._accel_core(q2, v2, tau_c_fn(q2, v2, cc))[0]
            q3 = self.integrate_components(qc, [0.5 * dt * x for x in v2])
            v3_ = [vc[k] + 0.5 * dt * k2a[k] for k in range(nv)]
            k3a = self._accel_core(q3, v3_, tau_c_fn(q3, v3_, cc))[0]
            q4 = self.integrate_components(qc, [dt * x for x in v3_])
            v4 = [vc[k] + dt * k3a[k] for k in range(nv)]
            k4a = self._accel_core(q4, v4, tau_c_fn(q4, v4, cc))[0]
            dq = [(dt / 6.0) * (vc[k] + 2.0 * v2[k] + 2.0 * v3_[k] + v4[k]) for k in range(nv)]
            dv = [(dt / 6.0) * (k1a[k] + 2.0 * k2a[k] + 2.0 * k3a[k] + k4a[k]) for k in range(nv)]
            return self.integrate_components(qc, dq), [vc[k] + dv[k] for k in range(nv)]

        return substep

    # ---------------- wrappers: plain on the CPU, kernel on the card ----------------
    def accel(self, q, v, tau):
        """Forward dynamics (..., nv): `cdyn_accel` on a CUDA tensor, the
        plain `_accel_core` on a CPU tensor."""
        if _route(q) == "kernel":
            return self.accel_kernel(q, v, tau)
        return self.accel_plain(q, v, tau)

    def accel_plain(self, q, v, tau):
        nq, nv = self.model.nq, self.model.nv
        batch = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1], tau.shape[:-1])
        qdd, _ = self._accel_core(
            [q[..., i] for i in range(nq)],
            [v[..., i] for i in range(nv)],
            [tau[..., i] for i in range(nv)],
        )
        return _stack(qdd, batch, q)

    def accel_kernel(self, q, v, tau):
        packed = self.pack(None, 0.0, (), q.device, q.dtype)
        return _launch_accel(packed, q, v, tau)

    def pack(self, tau_c, dt: float, imu_frames: tuple, device, dtype) -> "PackedModel":
        """The kernel's constant buffers for this model (cached). The key
        holds `tau_c` itself (hashed by identity), so a freed transmission's
        address can never be mistaken for a live one."""
        key = (tau_c, float(dt), tuple(imu_frames), torch.device(device), dtype)
        packed = self._packed.get(key)
        if packed is None:
            packed = pack_model(self, tau_c, dt, imu_frames, device, dtype)
            self._packed[key] = packed
        return packed

    def make_period_integrator(self, tau_c, dt: float, n_substeps: int,
                               integrator: str = "rk4", imu_frames: tuple = ()):
        """`(q, v, cmd) -> (q', v', extras)`: one controller period of
        `n_substeps` substeps under a fixed command, then the end-of-period
        extras `[a | f_world | w_local | depth | imu]`."""
        return PeriodIntegrator(self, tau_c, dt, n_substeps, integrator, tuple(imu_frames))

    def make_rollout_integrator(self, tau_c, dt: float, n_substeps: int, n_ticks: int,
                                controller, integrator: str = "rk4",
                                imu_frames: tuple = ()):
        """`(q, v, action, carry) -> (q', v', extras)`: one whole env step of
        `n_ticks` controller periods with the controller re-evaluated at each
        period start; extras = period extras + last command + new carry."""
        return RolloutIntegrator(
            self, tau_c, dt, n_substeps, n_ticks, controller, integrator, tuple(imu_frames)
        )

    def n_extra(self, imu_frames: tuple) -> int:
        nc = len(self.contact_frames) if self.has_contacts else 0
        return self.model.nv + 10 * nc + 6 * len(imu_frames)


def _route(t: torch.Tensor) -> str:
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "cuda":
        return "kernel"
    raise ValueError(f"cdyn: no kernel and no plain version for device {t.device}")


def _stack(comps, batch, like: torch.Tensor) -> torch.Tensor:
    """Stack components (tensors or Python floats) on a last axis."""
    if not comps:
        return like.new_zeros(tuple(batch) + (0,))
    cols = [
        c.to(like.dtype).expand(batch) if isinstance(c, torch.Tensor) else like.new_full(batch, float(c))
        for c in comps
    ]
    return torch.stack(cols, dim=-1)


_INTEGRATORS = {"euler": 0, "rk4": 1}


class PeriodIntegrator:
    """One controller period; `plain` and `kernel` are callable directly
    (the smoke script holds one against the other), `__call__` routes by
    device."""

    def __init__(self, cd, tau_c, dt, n_substeps, integrator, imu_frames):
        if integrator not in _INTEGRATORS:
            raise ValueError(f"unknown fixed-step integrator {integrator!r}")
        refuse_spherical(cd.model, "cdyn_period (and its plain version)")
        self.cd, self.tau_c, self.dt = cd, tau_c, float(dt)
        self.n_substeps, self.integrator, self.imu_frames = int(n_substeps), integrator, imu_frames
        self.substep = cd._build_substep(tau_c, self.dt, integrator)
        self.final_outputs = cd._build_final_outputs(tau_c, imu_frames)

    def __call__(self, q, v, cmd):
        if _route(q) == "kernel":
            return self.kernel(q, v, cmd)
        return self.plain(q, v, cmd)

    def plain(self, q, v, cmd, n_substeps: Optional[int] = None):
        n_substeps = self.n_substeps if n_substeps is None else n_substeps
        model = self.cd.model
        batch = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1], cmd.shape[:-1])
        qc = [q[..., i] for i in range(model.nq)]
        vc = [v[..., i] for i in range(model.nv)]
        cc = [cmd[..., i] for i in range(cmd.shape[-1])]
        for _ in range(n_substeps):
            qc, vc = self.substep(qc, vc, cc)
        extras = self.final_outputs(qc, vc, cc)
        return _stack(qc, batch, q), _stack(vc, batch, q), _stack(extras, batch, q)

    def kernel(self, q, v, cmd, n_substeps: Optional[int] = None):
        n_substeps = self.n_substeps if n_substeps is None else n_substeps
        packed = self.cd.pack(self.tau_c, self.dt, self.imu_frames, q.device, q.dtype)
        return _launch_period(
            packed, q, v, cmd, n_substeps, _INTEGRATORS[self.integrator],
            self.cd.n_extra(self.imu_frames),
        )


class RolloutIntegrator:
    """One whole env step; `plain` and `kernel` as in `PeriodIntegrator`."""

    def __init__(self, cd, tau_c, dt, n_substeps, n_ticks, controller, integrator, imu_frames):
        if integrator not in _INTEGRATORS:
            raise ValueError(f"unknown fixed-step integrator {integrator!r}")
        refuse_spherical(cd.model, "cdyn_rollout (and its plain version)")
        self.cd, self.tau_c, self.dt = cd, tau_c, float(dt)
        self.n_substeps, self.n_ticks = int(n_substeps), int(n_ticks)
        self.controller, self.integrator, self.imu_frames = controller, integrator, imu_frames
        self._ctrl_packed = {}
        self.substep = cd._build_substep(tau_c, self.dt, integrator)
        self.final_outputs = cd._build_final_outputs(tau_c, imu_frames)

    def __call__(self, q, v, action, carry):
        if _route(q) == "kernel":
            return self.kernel(q, v, action, carry)
        return self.plain(q, v, action, carry)

    def plain(self, q, v, action, carry, n_ticks: Optional[int] = None,
              n_substeps: Optional[int] = None):
        n_ticks = self.n_ticks if n_ticks is None else n_ticks
        n_substeps = self.n_substeps if n_substeps is None else n_substeps
        model = self.cd.model
        batch = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1])
        qc = [q[..., i] for i in range(model.nq)]
        vc = [v[..., i] for i in range(model.nv)]
        bc = [carry[..., i] for i in range(carry.shape[-1])]
        ac = [action[..., i] for i in range(action.shape[-1])]
        cc = [0.0] * self.controller.n_cmd
        for _ in range(n_ticks):
            cc, bc = self.controller(qc, vc, bc, ac)
            for _ in range(n_substeps):
                qc, vc = self.substep(qc, vc, cc)
        extras = self.final_outputs(qc, vc, cc) + list(cc) + list(bc)
        return _stack(qc, batch, q), _stack(vc, batch, q), _stack(extras, batch, q)

    def kernel(self, q, v, action, carry, n_ticks: Optional[int] = None,
               n_substeps: Optional[int] = None):
        n_ticks = self.n_ticks if n_ticks is None else n_ticks
        n_substeps = self.n_substeps if n_substeps is None else n_substeps
        packed = self.cd.pack(self.tau_c, self.dt, self.imu_frames, q.device, q.dtype)
        key = (q.device, q.dtype)
        ctrl = self._ctrl_packed.get(key)
        if ctrl is None:
            ctrl = self._ctrl_packed[key] = self.controller.pack(q.device, q.dtype)
        n_extra = self.cd.n_extra(self.imu_frames) + self.controller.n_cmd + carry.shape[-1]
        return _launch_rollout(
            packed, ctrl, self.controller.kind, q, v, action, carry, n_ticks, n_substeps,
            _INTEGRATORS[self.integrator], self.controller.n_cmd, n_extra,
        )


# --------------------------------------------------------------------------- #
# Motor transmission and in-kernel controllers: plain callables that also
# pack their constants for the kernel.
# --------------------------------------------------------------------------- #

MOTOR_NONE, MOTOR_CLIP, MOTOR_ENVELOPE = 0, 1, 2


@dataclasses.dataclass(eq=False)
class MotorTransmission:
    """Motor commands -> joint torques, component-wise (mirror of
    `MotorBank.compute_efforts`, reference `basic_motors.cc:100-143`)."""

    nv: int
    v_indices: tuple
    mode: tuple  # MOTOR_NONE / MOTOR_CLIP / MOTOR_ENVELOPE per motor
    friction: tuple  # bool per motor
    red: tuple
    el: tuple
    vl: tuple
    denom: tuple
    fvp: tuple
    fvn: tuple
    fdp: tuple
    fdn: tuple
    fds: tuple

    @staticmethod
    def from_motor_bank(motors, nv: int) -> "MotorTransmission":
        f = lambda arr: [float(x) for x in np.asarray(arr, np.float64)]  # noqa: E731
        red, el, vl = f(motors.mechanical_reduction), f(motors.effort_limit), f(motors.velocity_limit)
        inv_s = f(motors.velocity_effort_inv_slope)
        en_e, en_v = f(motors.enable_effort_limit), f(motors.enable_velocity_limit)
        mode, denom = [], []
        for m in range(motors.nmotors):
            # inf effort limit x zero slope -> no envelope (avoid inf*0=nan)
            vel_delta = el[m] * inv_s[m] if math.isfinite(el[m]) else 0.0
            if en_e[m] > 0 and en_v[m] > 0 and vel_delta > 0.0:
                vel_thr = max(vl[m] - vel_delta, 0.0)
                mode.append(MOTOR_ENVELOPE)
                denom.append(max(vl[m] - vel_thr, 1e-12))
            else:
                mode.append(MOTOR_CLIP if en_e[m] > 0 else MOTOR_NONE)
                denom.append(1.0)
        return MotorTransmission(
            nv=nv,
            v_indices=tuple(motors.v_indices),
            mode=tuple(mode),
            friction=tuple(x > 0 for x in f(motors.enable_friction)),
            red=tuple(red),
            el=tuple(el),
            vl=tuple(vl),
            denom=tuple(denom),
            fvp=tuple(f(motors.friction_viscous_pos)),
            fvn=tuple(f(motors.friction_viscous_neg)),
            fdp=tuple(f(motors.friction_dry_pos)),
            fdn=tuple(f(motors.friction_dry_neg)),
            fds=tuple(f(motors.friction_dry_slope)),
        )

    @property
    def nmotors(self) -> int:
        return len(self.v_indices)

    def __call__(self, qc, vc, cc):
        tc = [0.0] * self.nv
        for m, vi in enumerate(self.v_indices):
            v_j = vc[vi]
            u = cc[m]
            if self.mode[m] == MOTOR_ENVELOPE:
                v_m = self.red[m] * v_j
                smin = _clip((self.vl[m] + v_m) / self.denom[m], 0.0, 1.0)
                smax = _clip((self.vl[m] - v_m) / self.denom[m], 0.0, 1.0)
                u = _clip(u, -self.el[m] * smin, self.el[m] * smax)
            elif self.mode[m] == MOTOR_CLIP:
                u = _clip(u, -self.el[m], self.el[m])
            u_t = self.red[m] * u
            if self.friction[m]:
                u_t = u_t + torch.where(
                    v_j > 0.0,
                    self.fvp[m] * v_j + self.fdp[m] * torch.tanh(self.fds[m] * v_j),
                    self.fvn[m] * v_j + self.fdn[m] * torch.tanh(self.fds[m] * v_j),
                )
            tc[vi] = tc[vi] + u_t
        return tc


CONTROLLER_ZOH, CONTROLLER_PD = 0, 1


class ZOHPassThrough:
    """Zero-order hold of the env action over the env step: the motor
    command is the action, there is no carry (zero width, taken as is)."""

    kind = CONTROLLER_ZOH

    def __init__(self, n_cmd: int):
        self.n_cmd = int(n_cmd)
        self.n_carry = 0

    def __call__(self, qc, vc, bc, ac):
        return list(ac[: self.n_cmd]), list(bc)

    def pack(self, device, dtype):
        return (
            torch.tensor([self.n_cmd], dtype=torch.int32, device=device),
            torch.zeros(1, dtype=dtype, device=device),
        )


@dataclasses.dataclass(eq=False)
class PDComponents:
    """Component-wise PD controller with ZOH integration of the clipped
    (pos, vel, acc) command state: the in-kernel form of
    `gym.blocks.PDController.compute`. Carry = `[pos* | vel* | acc*]`."""

    kind = CONTROLLER_PD
    dt: float
    kp: tuple
    kd: tuple
    smin: tuple  # (3, nm) nested tuples
    smax: tuple
    eff: tuple
    red: tuple  # encoder reduction
    q_indices: tuple  # encoder q index per motor
    v_indices: tuple
    joint_side: tuple
    # Per motor: its encoder reads a (cos, sin) pair, the angle by atan2. A
    # model with such joints never reaches the kernels (`supports_model`).
    unbounded: tuple = ()

    @property
    def n_cmd(self) -> int:
        return len(self.kp)

    @property
    def n_carry(self) -> int:
        return 3 * self.n_cmd

    def __call__(self, qc, vc, bc, ac):
        nm, dt = self.n_cmd, self.dt
        smin, smax = self.smin, self.smax
        cc = []
        bc_new = [None] * (3 * nm)
        for i in range(nm):
            p, vel = bc[i], bc[nm + i]
            acc_min, acc_max = smin[2][i], smax[2][i]
            accel = _clip(ac[i], acc_min, acc_max)
            v_prev = vel
            vel = _clip(vel + accel * dt, smin[1][i], smax[1][i])
            horizon = torch.clamp(torch.floor(torch.abs(v_prev) / acc_max / dt) * dt, min=dt)
            pos_min_d = smin[0][i] - p
            pos_max_d = smax[0][i] - p
            drift = torch.where(horizon > dt, 0.5 * (horizon * (horizon - dt)) * acc_max, 0.0)
            vel = _clip(vel, (pos_min_d - drift) / horizon, (pos_max_d + drift) / horizon)
            over = torch.abs(vel) > dt * acc_max
            safe_v = torch.where(torch.abs(vel) > 1e-12, vel, 1.0)
            v_lo2 = -torch.clamp((pos_min_d - drift) / safe_v, min=dt) * acc_max
            v_hi2 = torch.clamp((pos_max_d + drift) / safe_v, min=dt) * acc_max
            vel = torch.where(over, _clip(vel, v_lo2, v_hi2), vel)
            accel_out = (vel - v_prev) / dt
            p = p + dt * vel
            qi = self.q_indices[i]
            if self.unbounded and self.unbounded[i]:
                pos_m = torch.atan2(qc[qi + 1], qc[qi])
            else:
                pos_m = qc[qi]
            vel_m = vc[self.v_indices[i]]
            if not self.joint_side[i]:
                pos_m = pos_m * self.red[i]
                vel_m = vel_m * self.red[i]
            u = self.kp[i] * ((p - pos_m) + self.kd[i] * (vel - vel_m))
            cc.append(_clip(u, -self.eff[i], self.eff[i]))
            bc_new[i] = p
            bc_new[nm + i] = vel
            bc_new[2 * nm + i] = accel_out
        return cc, bc_new

    def pack(self, device, dtype):
        """Int buffer `[nm | (q_index, v_index, joint_side) per motor]`, float
        buffer `[dt | (kp, kd, smin0..2, smax0..2, eff, red) per motor]`
        (read by `pd_controller` in csrc/cdyn.cu)."""
        if any(self.unbounded):
            raise NotImplementedError(
                "the kernels' PD controller reads no (cos, sin) encoder: a model with "
                "continuous joints runs the generic path"
            )
        ints = [self.n_cmd]
        floats = [self.dt]
        for i in range(self.n_cmd):
            ints += [self.q_indices[i], self.v_indices[i], int(bool(self.joint_side[i]))]
            floats += [self.kp[i], self.kd[i], *(self.smin[k][i] for k in range(3)),
                       *(self.smax[k][i] for k in range(3)), self.eff[i], self.red[i]]
        return (
            torch.tensor(ints, dtype=torch.int32, device=device),
            torch.tensor(floats, dtype=torch.float64).to(device=device, dtype=dtype),
        )


# --------------------------------------------------------------------------- #
# Constant packing (layout read by csrc/cdyn.cu, `struct Model`)
# --------------------------------------------------------------------------- #

CI_HEADER = 16  # NJ NQ NV NC NI NM NB has_contacts blend, spring offset, terrain offsets
CI_SPRING = 9  # header slot: where the spring section (`spring_section`) starts
# header slots: where the terrain section (`utils.terrain.pack_ground`) starts
# in ci and in cf; 0 on flat ground
CI_TERRAIN = 10
# Axis classes: a 1-dof joint's (-1 FREE), and SPHERICAL's own
AX_X, AX_Y, AX_Z, AX_GENERAL, AX_SPHERICAL = 0, 1, 2, 3, 4
CF_HEADER = 16  # g(3) stiffness damping friction v_trans eps_trans dt dt/2 dt/6
CI_JOINT, CI_CONTACT, CI_IMU, CI_MOTOR, CI_BOUND = 4, 2, 1, 3, 2
CF_JOINT, CF_CONTACT, CF_IMU, CF_MOTOR, CF_BOUND = 57, 13, 12, 9, 4


@dataclasses.dataclass(eq=False)
class PackedModel:
    ci: torch.Tensor  # int32
    cf: torch.Tensor  # the run's float dtype
    counts: dict  # nj, nq, nv, nc, ni, nm, nb, nsph (SPHERICAL joints)
    terrain: int = 0  # 1: the ground's program is packed (the kernels' terrain instance)


def axis_class(joint_type, axis) -> int:
    """AX_X, AX_Y or AX_Z for a 1-dof joint whose axis has exactly one
    non-zero component (the coordinate axis it lies on, either sign, as
    Pinocchio's RX/RY/RZ joints), AX_GENERAL otherwise; -1 for FREE,
    AX_SPHERICAL for SPHERICAL (its motion subspace the angular block)."""
    if jt.JointType(joint_type) == jt.JointType.FREE:
        return -1
    if jt.JointType(joint_type) == jt.JointType.SPHERICAL:
        return AX_SPHERICAL
    nonzero = [k for k in range(3) if float(axis[k]) != 0.0]
    return nonzero[0] if len(nonzero) == 1 else AX_GENERAL


def spring_section(cd: ComponentDynamics, tau_c: Optional[MotorTransmission]) -> list:
    """The spring kernels' int section (csrc/spring.cuh, `SpTree`): [nlev,
    motors on distinct dofs, lstart (nlev + 1)], then per slot its joint, per
    joint its slot, per slot its parent's slot, the slot of its child of
    highest joint index and of its next lower-index sibling (-1 for none),
    per joint its axis class and the index of the penalty bound on its dof
    (-1 for none; bounds in `pack_model`'s order). Slots list the joints depth
    after depth, in joint order within a depth."""
    c = cd.c
    depth = []
    for i in range(c.nj):
        depth.append(0 if c.parents[i] < 0 else depth[c.parents[i]] + 1)
    nlev = max(depth) + 1 if depth else 0
    jorder = sorted(range(c.nj), key=lambda i: (depth[i], i))
    lstart = [sum(1 for d in depth if d < lev) for lev in range(nlev + 1)]
    slot = [0] * c.nj
    for s, j in enumerate(jorder):
        slot[j] = s
    pslot = [slot[c.parents[j]] if c.parents[j] >= 0 else -1 for j in jorder]
    fchild, nsib = [-1] * c.nj, [-1] * c.nj
    for j in range(c.nj):  # children in ascending index: each becomes the first
        p = c.parents[j]
        if p >= 0:
            nsib[slot[j]] = fchild[slot[p]]
            fchild[slot[p]] = slot[j]
    dofs = list(tau_c.v_indices) if tau_c is not None else []
    distinct = int(len(set(dofs)) == len(dofs))
    axes = [axis_class(c.types[j], c.axis[j]) for j in range(c.nj)]
    bound_of_dof = {vi: b for b, vi in enumerate(sorted(cd.bound_gains))}
    bound = [bound_of_dof.get(c.idx_v[j], -1) if c.types[j] != jt.JointType.FREE else -1
             for j in range(c.nj)]
    return [nlev, distinct, *lstart, *jorder, *slot, *pslot, *fchild, *nsib, *axes, *bound]


def pack_model(cd: ComponentDynamics, tau_c: Optional[MotorTransmission], dt: float,
               imu_frames: tuple, device, dtype) -> PackedModel:
    """Pack the model, contact, bound, IMU and motor constants of one
    component core into an int buffer and a float buffer on `device`, and
    the ground's program (`utils.terrain.pack_ground`) as their terrain
    section when the core has a ground. Floats are computed in float64 on
    the host, exactly as the plain version computes its Python-float
    constants, then rounded once to `dtype`."""
    c, model = cd.c, cd.model
    nc, ni = len(cd.contact_frames), len(imu_frames)
    nm = tau_c.nmotors if tau_c is not None else 0
    bounds = sorted(cd.bound_gains.items())
    opts = cd.contact_opts
    ci = [model.njoints, model.nq, model.nv, nc, ni, nm, len(bounds),
          int(cd.has_contacts), int(opts is not None and opts.transition_eps > 1e-12)]
    ci += [0] * (CI_HEADER - len(ci))
    cf = list(cd.gravity)
    if opts is not None:
        cf += [opts.stiffness, opts.damping, opts.friction, opts.transition_velocity,
               opts.transition_eps]
    else:
        cf += [0.0] * 5
    cf += [dt, 0.5 * dt, dt / 6.0]
    cf += [0.0] * (CF_HEADER - len(cf))
    for i in range(c.nj):
        ci += [c.parents[i], int(c.types[i]), c.idx_q[i], c.idx_v[i]]
        cf += [x for row in c.rot[i] for x in row] + list(c.pos[i]) + list(c.axis[i])
        cf += list(axis_products(c.axis[i]))
        cf += [x for row in c.ia0[i] for x in row]
    cf += c.armature + c.damping
    for fidx, radius in zip(cd.contact_frames, cd.contact_radii):
        ci += [c.frame_parents[fidx], int(radius > 0.0)]
        cf += list(c.fpos[fidx]) + [x for row in c.frot[fidx] for x in row] + [radius]
    for fidx in imu_frames:
        ci += [c.frame_parents[fidx]]
        cf += [x for row in c.frot[fidx] for x in row] + list(c.fpos[fidx])
    for m in range(nm):
        ci += [tau_c.v_indices[m], tau_c.mode[m], int(tau_c.friction[m])]
        cf += [tau_c.red[m], tau_c.el[m], tau_c.vl[m], tau_c.denom[m], tau_c.fvp[m],
               tau_c.fvn[m], tau_c.fdp[m], tau_c.fdn[m], tau_c.fds[m]]
    for vi, (lo, hi, kp, kd, qi) in bounds:
        ci += [vi, qi]
        cf += [lo, hi, kp, kd]
    ci[CI_SPRING] = len(ci)
    ci += spring_section(cd, tau_c)
    terrain_on = cd.ground_fn is not None
    if terrain_on:
        ti, tf = terrain.pack_ground(cd.ground_fn)
        ci[CI_TERRAIN], ci[CI_TERRAIN + 1] = len(ci), len(cf)
        ci += ti.tolist()
        cf += tf.tolist()
    counts = dict(nj=model.njoints, nq=model.nq, nv=model.nv, nc=nc, ni=ni, nm=nm,
                  nb=len(bounds), nsph=sum(t == jt.JointType.SPHERICAL for t in c.types))
    return PackedModel(
        ci=torch.tensor(ci, dtype=torch.int32, device=device),
        cf=torch.tensor(cf, dtype=torch.float64).to(device=device, dtype=dtype),
        counts=counts,
        terrain=int(terrain_on),
    )


# --------------------------------------------------------------------------- #
# Kernel launches
# --------------------------------------------------------------------------- #


class Kernel:
    """One CUDA entry point and its launch count."""

    def __init__(self, name: str, replaces: str):
        self.name = name
        self.replaces = replaces
        self.launches = 0


KERNELS = {
    "cdyn_accel": Kernel("cdyn_accel", "jiminy_tpu/ops/cdyn.py:1215 _pallas_accel_fn"),
    "cdyn_period": Kernel("cdyn_period", "jiminy_tpu/ops/cdyn.py:1262 _pallas_period_fn"),
    "cdyn_rollout": Kernel("cdyn_rollout", "jiminy_tpu/ops/cdyn.py:1509 _pallas_rollout_fn"),
    # The constrained (PGS) bodies of the last two (jiminy_torch/engine/solver.py)
    "cdyn_period_cm": Kernel(
        "cdyn_period_cm", "jiminy_tpu/ops/cdyn.py:1262 _pallas_period_fn (constrained body)"
    ),
    "cdyn_rollout_cm": Kernel(
        "cdyn_rollout_cm", "jiminy_tpu/ops/cdyn.py:1509 _pallas_rollout_fn (constrained body)"
    ),
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _soa(x: torch.Tensor, batch, n: int) -> torch.Tensor:
    """(..., n) -> (n, B) contiguous struct-of-arrays."""
    return x.expand(tuple(batch) + (n,)).reshape(math.prod(batch), n).t().contiguous()


def _check_inputs(packed: PackedModel, *xs: torch.Tensor) -> None:
    dev, dtype = packed.cf.device, packed.cf.dtype
    if dev.type != "cuda":
        raise ValueError(f"cdyn kernels take CUDA tensors, got {dev}")
    for x in xs:
        if x.device != dev or x.dtype != dtype:
            raise ValueError(
                f"cdyn kernel: tensor on {x.device}/{x.dtype}, constants on {dev}/{dtype}"
            )


def _launch(name: str, dtype, *args) -> None:
    from jiminy_torch.ops import kernels

    lib = kernels.load()
    fn = lib.entry(name, dtype)
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} ({kernels.error_string(rc)})")
    KERNELS[name].launches += 1


def _rows(x: torch.Tensor, batch, n: int) -> torch.Tensor:
    """(..., n) -> (B, n) contiguous rows (no copy for a contiguous batch)."""
    return x.expand(tuple(batch) + (n,)).reshape(math.prod(batch), n).contiguous()


def accel_smem_per_env(packed: PackedModel, dtype) -> int:
    """Bytes of dynamic shared memory one env of cdyn_accel takes (with the
    SPHERICAL joints' blocks); a block's share past what the card grants
    fails at the launch."""
    from jiminy_torch.ops import kernels

    c = packed.counts
    elt = torch.empty((), dtype=dtype).element_size()
    return kernels.load().accel_smem_bytes(c["nj"], c["nq"], c["nv"], c["nc"], elt,
                                           c["nsph"])[0]


def _launch_accel(packed: PackedModel, q, v, tau):
    _check_inputs(packed, q, v, tau)
    nq, nv = packed.counts["nq"], packed.counts["nv"]
    smem = accel_smem_per_env(packed, q.dtype)
    batch = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1], tau.shape[:-1])
    qs, vs, ts = _rows(q, batch, nq), _rows(v, batch, nv), _rows(tau, batch, nv)
    b = qs.shape[0]
    out = torch.empty((b, nv), dtype=q.dtype, device=q.device)
    if b:
        _launch("cdyn_accel", q.dtype, packed.ci.data_ptr(), packed.cf.data_ptr(), qs.data_ptr(),
                vs.data_ptr(), ts.data_ptr(), out.data_ptr(), b, smem, packed.terrain,
                int(packed.counts["nsph"] > 0))
    return out.reshape(tuple(batch) + (nv,))


def sp_smem_per_env(packed: PackedModel, n_cmd: int, n_action: int, n_carry: int, dtype) -> int:
    """Bytes of dynamic shared memory one env of a spring launch (cdyn_period,
    cdyn_rollout) takes; a block's share past what the card grants fails at
    the launch."""
    from jiminy_torch.ops import kernels

    c = packed.counts
    elt = torch.empty((), dtype=dtype).element_size()
    return kernels.load().sp_smem_bytes(c["nj"], c["nq"], c["nv"], c["nc"], n_cmd, n_action,
                                        n_carry, elt)[0]


def _launch_period(packed: PackedModel, q, v, cmd, n_substeps: int, integrator: int,
                   n_extra: int):
    _check_inputs(packed, q, v, cmd)
    nq, nv, nm = packed.counts["nq"], packed.counts["nv"], cmd.shape[-1]
    smem = sp_smem_per_env(packed, nm, 0, 0, q.dtype)
    if nm < packed.counts["nm"]:
        raise ValueError(f"cdyn_period: command width {nm} < {packed.counts['nm']} motors")
    batch = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1], cmd.shape[:-1])
    qs, vs, cs = _soa(q, batch, nq), _soa(v, batch, nv), _soa(cmd, batch, nm)
    b = qs.shape[1]
    qo = torch.empty((nq, b), dtype=q.dtype, device=q.device)
    vo = torch.empty((nv, b), dtype=q.dtype, device=q.device)
    eo = torch.empty((n_extra, b), dtype=q.dtype, device=q.device)
    if b:
        _launch("cdyn_period", q.dtype, packed.ci.data_ptr(), packed.cf.data_ptr(),
                qs.data_ptr(), vs.data_ptr(), cs.data_ptr(), qo.data_ptr(), vo.data_ptr(),
                eo.data_ptr(), b, nm, int(n_substeps), int(integrator), smem,
                packed.terrain)
    return (
        qo.t().reshape(tuple(batch) + (nq,)),
        vo.t().reshape(tuple(batch) + (nv,)),
        eo.t().reshape(tuple(batch) + (n_extra,)),
    )


def _launch_rollout(packed: PackedModel, ctrl, kind: int, q, v, action, carry,
                    n_ticks: int, n_substeps: int, integrator: int, n_cmd: int,
                    n_extra: int):
    _check_inputs(packed, q, v, action, carry)
    nq, nv = packed.counts["nq"], packed.counts["nv"]
    na, nb = action.shape[-1], carry.shape[-1]
    smem = sp_smem_per_env(packed, n_cmd, na, nb, q.dtype)
    if n_cmd < packed.counts["nm"]:
        raise ValueError(f"cdyn_rollout: command width {n_cmd} < {packed.counts['nm']} motors")
    if kind == CONTROLLER_ZOH and na < n_cmd:
        raise ValueError(f"cdyn_rollout: pass-through needs >= {n_cmd} action channels")
    batch = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1], action.shape[:-1], carry.shape[:-1])
    qs, vs = _soa(q, batch, nq), _soa(v, batch, nv)
    as_, bs = _soa(action, batch, na), _soa(carry, batch, nb)
    b = qs.shape[1]
    qo = torch.empty((nq, b), dtype=q.dtype, device=q.device)
    vo = torch.empty((nv, b), dtype=q.dtype, device=q.device)
    eo = torch.empty((n_extra, b), dtype=q.dtype, device=q.device)
    pi, pf = ctrl
    if b:
        _launch("cdyn_rollout", q.dtype, packed.ci.data_ptr(), packed.cf.data_ptr(),
                pi.data_ptr(), pf.data_ptr(), int(kind), qs.data_ptr(), vs.data_ptr(),
                as_.data_ptr(), bs.data_ptr(), qo.data_ptr(), vo.data_ptr(), eo.data_ptr(),
                b, na, nb, int(n_cmd), int(n_ticks), int(n_substeps), int(integrator), smem,
                packed.terrain)
    return (
        qo.t().reshape(tuple(batch) + (nq,)),
        vo.t().reshape(tuple(batch) + (nv,)),
        eo.t().reshape(tuple(batch) + (n_extra,)),
    )
