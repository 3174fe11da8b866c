"""Merged-model multi-robot formulation (port of `jiminy_tpu.engine.merge`).

The reference advances all robots with one shared stepper over their
concatenated state (`engine.cc:3497-3535`). Here that is literal:
`merge_robots` concatenates N robots into one forest-rooted `Robot` (every
pass of the dynamics already walks a tree with several roots), so one
`Engine` over the merged robot has every single-robot feature: the fixed
steps and DOPRI, the PGS warm starts, sensors, and the component core and its
kernels while no coupling force is registered.

Coupling forces are state forces on the merged engine
(`Engine.register_state_force`), evaluated from its one kinematics pass, so
action and reaction are equal and opposite by construction
(`engine/multi.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from jiminy_torch.engine.hardware import MotorBank, SensorSuite
from jiminy_torch.engine.robot import FlexibilityConfig, Robot
from jiminy_torch.models.model import ARRAY_FIELDS, RobotModel


@dataclasses.dataclass(frozen=True)
class RobotSlice:
    """Index ranges of one robot inside the merged robot; `sensors` maps a
    sensor group's name to the robot's range on the group's sensor axis."""

    q: slice
    v: slice
    joints: slice
    frames: slice
    motors: slice
    contacts: slice
    sensors: Dict[str, slice]


def _off(t: tuple, off: int) -> tuple:
    return tuple((x + off if x >= 0 else x) for x in t)


def _cat(arrays) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float64) for a in arrays], axis=0)


def merge_models(models: Dict[str, RobotModel], name: str) -> RobotModel:
    """Kinematic trees concatenated into one forest; joint and frame names
    prefixed "<robot>/" (the reference prefixes telemetry so)."""
    joint_off = q_off = v_off = 0
    meta = {k: [] for k in ("joint_names", "frame_names", "joint_types", "parents", "idx_q",
                            "idx_v", "frame_parents")}
    arr = {k: [] for k in ARRAY_FIELDS}
    for rname, m in models.items():
        meta["joint_names"] += [f"{rname}/{n}" for n in m.joint_names]
        meta["frame_names"] += [f"{rname}/{n}" for n in m.frame_names]
        meta["joint_types"] += list(m.joint_types)
        meta["parents"] += list(_off(m.parents, joint_off))
        meta["idx_q"] += [i + q_off for i in m.idx_q]
        meta["idx_v"] += [i + v_off for i in m.idx_v]
        meta["frame_parents"] += list(_off(m.frame_parents, joint_off))
        for k in arr:
            arr[k].append(getattr(m, k))
        joint_off += m.njoints
        q_off += m.nq
        v_off += m.nv
    return RobotModel(name=name, nq=q_off, nv=v_off, njoints=joint_off,
                      **{k: tuple(v) for k, v in meta.items()},
                      **{k: _cat(v) for k, v in arr.items()})


def _merge_motors(robots: Dict[str, Robot]):
    joint_off = q_off = v_off = 0
    index = {"names": [], "joint_indices": [], "v_indices": [], "q_indices": []}
    arrays: Dict[str, list] = {}
    for rname, r in robots.items():
        b = r.motors
        if b is not None and b.nmotors:
            index["names"] += [f"{rname}/{n}" for n in b.names]
            index["joint_indices"] += [i + joint_off for i in b.joint_indices]
            index["v_indices"] += [i + v_off for i in b.v_indices]
            index["q_indices"] += [i + q_off for i in b.q_indices]
            for f in dataclasses.fields(MotorBank):
                if f.name not in index:
                    arrays.setdefault(f.name, []).append(getattr(b, f.name))
        joint_off += r.model.njoints
        q_off += r.model.nq
        v_off += r.model.nv
    if not index["names"]:
        return None
    return MotorBank(**{k: tuple(v) for k, v in index.items()},
                     **{k: _cat(v) for k, v in arrays.items()})


_SHIFTED = {"frame_indices": "frame", "motor_indices": "motor", "q_indices": "q",
            "v_indices": "v", "contact_slots": "contact"}


def _merge_group(groups_with_offsets):
    """One sensor group type concatenated across the robots that have it,
    [(robot name, group, offsets)]: names prefixed, index tuples shifted by
    the robot's offsets, arrays concatenated."""
    cls = type(groups_with_offsets[0][1])
    out: Dict[str, object] = {}
    for f in dataclasses.fields(cls):
        vals = []
        for rname, g, offs in groups_with_offsets:
            v = getattr(g, f.name)
            if f.name == "names":
                vals.append(tuple(f"{rname}/{n}" for n in v))
            elif f.name in _SHIFTED:
                off = offs[_SHIFTED[f.name]]
                if v and isinstance(v[0], tuple):  # a force sensor's contact slots
                    vals.append(tuple(_off(s, off) for s in v))
                else:
                    vals.append(_off(v, off))
            else:
                vals.append(v)
        out[f.name] = sum(vals, ()) if isinstance(vals[0], tuple) else _cat(vals)
    return cls(**out)


def merge_robots(robots: Dict[str, Robot]) -> Tuple[Robot, Dict[str, RobotSlice]]:
    """Robots merged into one forest Robot and each robot's index layout;
    every field of `Robot` is carried (contact radii, loop pairs, rolling
    specs, flexibility, backlash, collision pairs, sensor groups)."""
    name = "+".join(robots)
    model = merge_models({n: r.model for n, r in robots.items()}, name)
    theoretical = merge_models({n: r.theoretical_model for n, r in robots.items()}, name)

    layout: Dict[str, RobotSlice] = {}
    joint_off = q_off = v_off = frame_off = motor_off = contact_off = 0
    sensor_off: Dict[str, int] = {}
    groups_by_kind: Dict[str, list] = {}
    contact_frames, contact_radii = [], []
    loop_pairs, rolling, backlash, pair_geoms = [], [], [], []
    flex_idx, flex_arrays = [], {"stiffness": [], "damping": [], "inertia": []}

    def prefixed(rname, frame):
        return f"{rname}/{frame}" if isinstance(frame, str) else frame + frame_off

    for rname, r in robots.items():
        offs = {"joint": joint_off, "q": q_off, "v": v_off, "frame": frame_off,
                "motor": motor_off, "contact": contact_off}
        sslices = {}
        for kind, g in r.sensors.groups():
            start = sensor_off.get(kind, 0)
            sslices[kind] = slice(start, start + g.nsensors)
            sensor_off[kind] = start + g.nsensors
            groups_by_kind.setdefault(kind, []).append((rname, g, offs))
        nm, nc = r.nmotors, len(r.contact_frame_indices)
        layout[rname] = RobotSlice(
            q=slice(q_off, q_off + r.model.nq),
            v=slice(v_off, v_off + r.model.nv),
            joints=slice(joint_off, joint_off + r.model.njoints),
            frames=slice(frame_off, frame_off + r.model.nframes),
            motors=slice(motor_off, motor_off + nm),
            contacts=slice(contact_off, contact_off + nc),
            sensors=sslices,
        )
        contact_frames += [i + frame_off for i in r.contact_frame_indices]
        contact_radii += list(r.contact_radii or (0.0,) * nc)
        loop_pairs += [(prefixed(rname, a), prefixed(rname, b)) for a, b in r.loop_pairs]
        rolling += [(prefixed(rname, f), radius, axis) for f, radius, axis in r.rolling_specs]
        backlash += [j + joint_off for j in r.backlash_joint_indices]
        pair_geoms += [((ga[0] + joint_off,) + tuple(ga[1:]), (gb[0] + joint_off,) + tuple(gb[1:]))
                       for ga, gb in r.collision_pairs_geom]
        if r.has_flexibility:
            flex_idx += [j + joint_off for j in r.flexibility.joint_indices]
            for k in flex_arrays:
                flex_arrays[k].append(getattr(r.flexibility, k))
        joint_off += r.model.njoints
        q_off += r.model.nq
        v_off += r.model.nv
        frame_off += r.model.nframes
        motor_off += nm
        contact_off += nc

    flex = (FlexibilityConfig(joint_indices=tuple(flex_idx),
                              **{k: _cat(v) for k, v in flex_arrays.items()})
            if flex_idx else None)
    merged = Robot(
        name=name,
        model=model,
        theoretical_model=theoretical,
        motors=_merge_motors(robots),
        sensors=SensorSuite(**{kind: _merge_group(entries)
                               for kind, entries in groups_by_kind.items()}),
        contact_frame_indices=tuple(contact_frames),
        contact_radii=tuple(contact_radii),
        flexibility=flex,
        loop_pairs=tuple(loop_pairs),
        backlash_joint_indices=tuple(backlash),
        rolling_specs=tuple(rolling),
        collision_pairs_geom=tuple(pair_geoms),
    )
    return merged, layout
