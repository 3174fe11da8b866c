"""The static robot model (port of `jiminy_tpu.models.model`).

The kinematic structure (joint types, parents, index maps, frame tree) is
plain Python metadata and every numeric quantity is a host float64 numpy
array. `RobotModel.tensor` places an array on a device in a dtype, once, and
caches it, so the same model serves CPU tests at float64 and the card at
float32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from jiminy_torch.models import joints as jt

# Numeric fields, in the order of `jiminy_tpu.models.model.RobotModel`.
ARRAY_FIELDS = (
    "jplacement_rot",  # (nj, 3, 3) joint attachment frame in the parent joint frame
    "jplacement_pos",  # (nj, 3)
    "joint_axes",  # (nj, 3)
    "mass",  # (nj,)
    "com",  # (nj, 3) CoM in the joint frame
    "inertia",  # (nj, 3, 3) rotational inertia about the CoM
    "armature",  # (nv,)
    "damping",  # (nv,)
    "position_limit_lower",  # (nq,)
    "position_limit_upper",  # (nq,)
    "velocity_limit",  # (nv,)
    "effort_limit",  # (nv,)
    "fplacement_rot",  # (nf, 3, 3) frame placement in its parent joint frame
    "fplacement_pos",  # (nf, 3)
)

META_FIELDS = (
    "name",
    "nq",
    "nv",
    "njoints",
    "joint_types",
    "parents",
    "idx_q",
    "idx_v",
    "joint_names",
    "frame_names",
    "frame_parents",
)


@dataclasses.dataclass(eq=False)
class RobotModel:
    name: str
    nq: int
    nv: int
    njoints: int
    joint_types: tuple
    parents: tuple
    idx_q: tuple
    idx_v: tuple
    joint_names: tuple
    frame_names: tuple
    frame_parents: tuple
    jplacement_rot: np.ndarray
    jplacement_pos: np.ndarray
    joint_axes: np.ndarray
    mass: np.ndarray
    com: np.ndarray
    inertia: np.ndarray
    armature: np.ndarray
    damping: np.ndarray
    position_limit_lower: np.ndarray
    position_limit_upper: np.ndarray
    velocity_limit: np.ndarray
    effort_limit: np.ndarray
    fplacement_rot: np.ndarray
    fplacement_pos: np.ndarray
    _placed: dict = dataclasses.field(default_factory=dict, repr=False)

    # ------------------------------------------------------------------ #
    @property
    def nframes(self) -> int:
        return len(self.frame_names)

    def joint_index(self, name: str) -> int:
        return self.joint_names.index(name)

    def frame_index(self, name: str) -> int:
        return self.frame_names.index(name)

    def nv_of(self, i: int) -> int:
        return jt.JOINT_NV[jt.JointType(self.joint_types[i])]

    def nq_of(self, i: int) -> int:
        return jt.JOINT_NQ[jt.JointType(self.joint_types[i])]

    def q_slice(self, i: int) -> slice:
        return slice(self.idx_q[i], self.idx_q[i] + self.nq_of(i))

    def v_slice(self, i: int) -> slice:
        return slice(self.idx_v[i], self.idx_v[i] + self.nv_of(i))

    def tensor(self, field: str, device, dtype) -> torch.Tensor:
        """`field` placed on `device` in `dtype` (cached per model)."""
        key = (field, torch.device(device), dtype)
        t = self._placed.get(key)
        if t is None:
            t = torch.as_tensor(np.asarray(getattr(self, field)), dtype=dtype, device=device)
            self._placed[key] = t
        return t

    def arrays(self) -> dict:
        """Host copies of every numeric field (see `convert.model_from_arrays`)."""
        return {f: np.array(getattr(self, f), dtype=np.float64) for f in ARRAY_FIELDS}

    # ------------------------------------------------------------------ #
    def neutral(self) -> np.ndarray:
        """Neutral configuration vector (host float64)."""
        segs = [jt.neutral_q(jt.JointType(t)) for t in self.joint_types]
        return np.concatenate(segs) if segs else np.zeros(0)

    def replace(self, **changes) -> "RobotModel":
        """Copy with fields replaced; the device cache starts empty."""
        return dataclasses.replace(self, _placed={}, **changes)

    def add_frame(self, name: str, parent_joint: int, rot, pos) -> "RobotModel":
        """New model with an extra operational frame (host-side op)."""
        return self.replace(
            frame_names=self.frame_names + (name,),
            frame_parents=self.frame_parents + (int(parent_joint),),
            fplacement_rot=np.concatenate(
                [self.fplacement_rot, np.asarray(rot, np.float64)[None]], axis=0
            ),
            fplacement_pos=np.concatenate(
                [self.fplacement_pos, np.asarray(pos, np.float64)[None]], axis=0
            ),
        )


def build_model(
    name: str,
    joint_specs: Sequence[dict[str, Any]],
    frame_specs: Sequence[dict[str, Any]] = (),
) -> RobotModel:
    """Assemble a RobotModel from per-joint dicts (host-side, float64).

    Joint spec: {name, type, parent, placement: (R, p), axis, mass, com,
    inertia, [armature], [damping], [position_limit], [velocity_limit],
    [effort_limit]}. Frame spec: {name, parent, placement: (R, p)}.
    """
    nj = len(joint_specs)
    joint_types, parents, idx_q, idx_v, names = [], [], [], [], []
    nq = nv = 0
    jrot = np.zeros((nj, 3, 3))
    jpos = np.zeros((nj, 3))
    axes = np.zeros((nj, 3))
    mass = np.zeros(nj)
    com = np.zeros((nj, 3))
    inertia = np.zeros((nj, 3, 3))
    armature, damping, pos_lo, pos_hi, vel_lim, eff_lim = [], [], [], [], [], []

    for i, spec in enumerate(joint_specs):
        t = jt.JointType(spec["type"])
        joint_types.append(int(t))
        parents.append(int(spec["parent"]))
        idx_q.append(nq)
        idx_v.append(nv)
        names.append(spec["name"])
        nq_j, nv_j = jt.JOINT_NQ[t], jt.JOINT_NV[t]
        nq += nq_j
        nv += nv_j
        r, p = spec.get("placement", (np.eye(3), np.zeros(3)))
        jrot[i], jpos[i] = np.asarray(r), np.asarray(p)
        axes[i] = np.asarray(spec.get("axis", (0.0, 0.0, 1.0)))
        mass[i] = float(spec.get("mass", 0.0))
        com[i] = np.asarray(spec.get("com", np.zeros(3)))
        inertia[i] = np.asarray(spec.get("inertia", np.zeros((3, 3))))
        armature.extend(np.broadcast_to(np.asarray(spec.get("armature", 0.0)), (nv_j,)))
        damping.extend(np.broadcast_to(np.asarray(spec.get("damping", 0.0)), (nv_j,)))
        lo, hi = spec.get("position_limit", (None, None))
        if t == jt.JointType.FREE:
            default_lo = np.concatenate([np.full(3, -np.inf), np.full(4, -1.0)])
            default_hi = np.concatenate([np.full(3, np.inf), np.full(4, 1.0)])
        elif t in (jt.JointType.REVOLUTE_UNBOUNDED, jt.JointType.SPHERICAL):
            default_lo, default_hi = np.full(nq_j, -1.0), np.full(nq_j, 1.0)
        else:
            default_lo, default_hi = np.full(nq_j, -np.inf), np.full(nq_j, np.inf)
        pos_lo.extend(np.asarray(lo) if lo is not None else default_lo)
        pos_hi.extend(np.asarray(hi) if hi is not None else default_hi)
        vel_lim.extend(np.broadcast_to(np.asarray(spec.get("velocity_limit", np.inf)), (nv_j,)))
        eff_lim.extend(np.broadcast_to(np.asarray(spec.get("effort_limit", np.inf)), (nv_j,)))

    nf = len(frame_specs)
    frot = np.zeros((nf, 3, 3))
    fpos = np.zeros((nf, 3))
    for i, f in enumerate(frame_specs):
        r, p = f.get("placement", (np.eye(3), np.zeros(3)))
        frot[i], fpos[i] = np.asarray(r), np.asarray(p)

    def arr(x):
        return np.array(x, dtype=np.float64)

    return RobotModel(
        name=name,
        nq=nq,
        nv=nv,
        njoints=nj,
        joint_types=tuple(joint_types),
        parents=tuple(parents),
        idx_q=tuple(idx_q),
        idx_v=tuple(idx_v),
        joint_names=tuple(names),
        frame_names=tuple(f["name"] for f in frame_specs),
        frame_parents=tuple(int(f["parent"]) for f in frame_specs),
        jplacement_rot=jrot,
        jplacement_pos=jpos,
        joint_axes=axes,
        mass=mass,
        com=com,
        inertia=inertia,
        armature=arr(armature),
        damping=arr(damping),
        position_limit_lower=arr(pos_lo),
        position_limit_upper=arr(pos_hi),
        velocity_limit=arr(vel_lim),
        effort_limit=arr(eff_lim),
        fplacement_rot=frot,
        fplacement_pos=fpos,
    )
