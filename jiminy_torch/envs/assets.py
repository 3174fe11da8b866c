"""Packaged robots built from the vendored reference asset files (port of
`jiminy_tpu.envs.assets`).

The URDF and `*_hardware.toml` files are read as data from the JAX package's
data directory; nothing of that package is imported. It loads the toys
(cartpole, acrobot, simple_pendulum: fixed base, no hardware file), the
ANYmal (point contact frames), Atlas (foot collision boxes expanded into
corner contact points, pruned to the support hull at the nominal pose;
locked joints folded away), and Cassie and Digit (toe meshes, collision or
visual, replaced by their oriented bounding box's corners, the four lowest
at the nominal pose kept; the passive shin joints locked; the pushrod loop
closures as distance constraints between frames added at the reference's
placements).
"""

from __future__ import annotations

import functools
import math
import os
from typing import Optional

import numpy as np
import torch

from jiminy_torch.engine.robot import Robot, box_corners
from jiminy_torch.hardware import load_hardware_description_file
from jiminy_torch.models import joints as jt
from jiminy_torch.models.urdf import (
    _resolve_mesh_path,
    build_model_from_urdf,
    load_mesh_vertices,
    oriented_bounding_box,
    parse_collision_geometries,
    parse_visual_geometries,
)
from jiminy_torch.ops.kinematics import forward_kinematics, frame_placement

DATA_DIR = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "jiminy_tpu", "data")
)

_ASSET_SUBDIRS = {
    "cartpole": "toys_models/cartpole",
    "acrobot": "toys_models/acrobot",
    "simple_pendulum": "toys_models/simple_pendulum",
    "anymal": "quadrupedal_robots/anymal",
    "atlas": "bipedal_robots/atlas",
    "cassie": "bipedal_robots/cassie",
    "digit": "bipedal_robots/digit",
}

# Passive joints folded away at build time (reference `buildReducedModel`
# calls: cassie.py:92-100, digit.py:108-116)
_LOCKED_JOINTS = {
    "cassie": ("knee_to_shin_left", "knee_to_shin_right"),
    "digit": ("shin_to_tarsus_left", "shin_to_tarsus_right"),
}


def robot_data_dir(name: str) -> str:
    try:
        sub = _ASSET_SUBDIRS[name]
    except KeyError:
        raise ValueError(
            f"no packaged assets for '{name}' in this slice of the port; "
            f"available: {sorted(_ASSET_SUBDIRS)}"
        ) from None
    return os.path.join(DATA_DIR, sub)


def urdf_path(name: str) -> str:
    return os.path.join(robot_data_dir(name), f"{name}.urdf")


def hardware_path(name: str) -> Optional[str]:
    p = os.path.join(robot_data_dir(name), f"{name}_hardware.toml")
    return p if os.path.exists(p) else None


# --------------------------------------------------------------------------- #
# Contact-point generation (reference avoid_instable_collisions)
# --------------------------------------------------------------------------- #


@functools.lru_cache(maxsize=None)
def _collision_body_specs(name: str, body: str) -> tuple[tuple, tuple]:
    """(collision_specs, candidate_points) for one collision body: boxes are
    replaced by their corner points and, on a body without boxes, meshes
    (collision, else the visual ones) by their oriented bounding box's
    corners (offsets in the LINK frame); other primitives stay collision
    specs; a body with no geometry gets one point at its frame. Computed
    once a process (a mesh's box search takes seconds); callers copy."""
    urdf = urdf_path(name)
    cols = parse_collision_geometries(urdf, links=(body,)).get(body, [])
    keep_specs = [s for s in cols if s["geometry"] not in ("box", "mesh")]
    points: list = []

    def add_points(offsets, rot, pos):
        rot, pos = np.asarray(rot, float), np.asarray(pos, float)
        points.extend(pos + rot @ np.asarray(o, float) for o in offsets)

    boxes = [s for s in cols if s["geometry"] == "box"]
    for s in boxes:
        add_points(box_corners(s["size"]), *s["origin"])
    if not boxes:
        meshes = [(s["points"], *s["origin"]) for s in cols if s["geometry"] == "mesh"]
        if not meshes:  # the visual-mesh fallback (reference robot.py:602-610)
            for s in parse_visual_geometries(urdf).get(body, []):
                if s.get("tag") != "mesh":
                    continue
                scale = np.array([float(x) for x in s["scale"].split()]) if s.get("scale") else None
                path = _resolve_mesh_path(s["filename"], robot_data_dir(name))
                meshes.append((load_mesh_vertices(path, scale), *s["origin"]))
        for verts, rot, pos in meshes:
            add_points(oriented_bounding_box(verts), rot, pos)
    if not keep_specs and not points:
        points.append(np.zeros(3))
    return tuple(keep_specs), tuple(points)


def _select_bottom_points(model, nominal_q, body, points, mode) -> list:
    """The candidate points a robot keeps (the reference envs' cleanup):
    "bottom4" the four lowest at the nominal pose (the toe slab's bottom face,
    `cassie.py:157-161`, `digit.py:169-172`); "hull" the lower half, then the
    vertices of its 2D convex hull (`atlas.py:100-112`); None all."""
    if mode is None or len(points) <= 4:
        return points
    kin = forward_kinematics(model, torch.as_tensor(nominal_q, dtype=torch.float64))
    rot, pos = frame_placement(model, kin, model.frame_index(body))
    rot, pos = rot.numpy(), pos.numpy()
    world = np.stack([pos + rot @ p for p in points])
    order = np.argsort(world[:, 2])
    if mode == "bottom4":
        return [points[i] for i in order[:4]]
    if mode == "hull":
        bottom = order[: max(len(points) // 2, 3)]
        try:
            from scipy.spatial import ConvexHull

            keep = bottom[np.unique(ConvexHull(world[bottom, :2]).vertices)]
        except Exception:  # a degenerate footprint keeps the lower half
            keep = bottom
        return [points[i] for i in keep]
    raise ValueError(f"unknown contact cleanup mode {mode!r}")


# --------------------------------------------------------------------------- #
# Nominal poses (reference env `_neutral` overrides)
# --------------------------------------------------------------------------- #


def _set_joint_angle(model, q, joint_name, theta):
    j = model.joint_index(joint_name)
    if jt.JointType(model.joint_types[j]) == jt.JointType.REVOLUTE_UNBOUNDED:
        q[model.idx_q[j]] = math.cos(theta)
        q[model.idx_q[j] + 1] = math.sin(theta)
    else:
        q[model.idx_q[j]] = theta


def nominal_pose(name: str, model) -> np.ndarray:
    """Reference `_neutral` configuration of a packaged robot (base at the
    origin; the env auto-levels the height onto the ground). The ANYmal's
    standing pose is `builders.anymal_standing_pose`."""
    q = np.asarray(model.neutral(), float).copy()
    if name == "cassie":  # cassie.py:20-24, 163-183
        for s in ("left", "right"):
            _set_joint_angle(model, q, f"hip_flexion_{s}", 25.0 / 180.0 * math.pi)
            _set_joint_angle(model, q, f"knee_joint_{s}", -65.0 / 180.0 * math.pi)
            _set_joint_angle(model, q, f"ankle_joint_{s}", 80.0 / 180.0 * math.pi)
            _set_joint_angle(model, q, f"toe_joint_{s}", -90.0 / 180.0 * math.pi)
    elif name == "digit":  # digit.py:25-28, 174-201
        for s, sign in (("left", 1.0), ("right", -1.0)):
            _set_joint_angle(model, q, f"hip_abduction_{s}", sign * 20.0 / 180.0 * math.pi)
            _set_joint_angle(model, q, f"hip_flexion_{s}", sign * 5.7 / 180.0 * math.pi)
            _set_joint_angle(model, q, f"shoulder_pitch_joint_{s}", sign * 45.0 / 180.0 * math.pi)
            _set_joint_angle(model, q, f"elbow_joint_{s}", sign * 68.0 / 180.0 * math.pi)
    elif name == "atlas":
        q = _atlas_posed(model, q)
    return q


# Reference `atlas.py:152-169` arm and back pose
ATLAS_POSE = {
    "back_bky": 0.2,
    "l_arm_elx": 0.2,
    "l_arm_shx": -math.pi / 2.0,
    "l_arm_shz": math.pi / 4.0,
    "l_arm_ely": math.pi / 4.0 + math.pi / 2.0,
    "r_arm_elx": -0.2,
    "r_arm_shx": math.pi / 2.0,
    "r_arm_shz": -math.pi / 4.0,
    "r_arm_ely": math.pi / 4.0 + math.pi / 2.0,
}


def _atlas_posed(model, q):
    for jn, th in ATLAS_POSE.items():
        if jn in model.joint_names:
            _set_joint_angle(model, q, jn, th)
    return q


# --------------------------------------------------------------------------- #
# Robot assembly
# --------------------------------------------------------------------------- #


# The pushrod attachment frames: (frame, parent joint or frame, translation)
# (reference cassie.py:122-152, digit.py:146-168)
_PUSHRODS = {
    "cassie": [
        ("right_pushrod_tarsus", "right_tarsus", (-0.12, 0.03, -0.005)),
        ("right_pushrod_hip", "hip_flexion_right", (0.0, 0.0, -0.045)),
        ("left_pushrod_tarsus", "left_tarsus", (-0.12, 0.03, 0.005)),
        ("left_pushrod_hip", "hip_flexion_left", (0.0, 0.0, 0.045)),
    ],
    "digit": [
        ("right_pushrod_tarsus", "right_tarsus", (-0.11, 0.0, 0.0)),
        ("right_pushrod_hip", "hip_flexion_right", (0.0, 0.0, 0.046)),
        ("left_pushrod_tarsus", "left_tarsus", (-0.11, 0.0, 0.0)),
        ("left_pushrod_hip", "hip_flexion_left", (0.0, 0.0, 0.046)),
    ],
}

_LOOP_PAIRS = {
    "cassie": [("right_pushrod_tarsus", "right_pushrod_hip"),
               ("left_pushrod_tarsus", "left_pushrod_hip")],
    "digit": [("right_pushrod_tarsus", "right_pushrod_hip"),
              ("left_pushrod_tarsus", "left_pushrod_hip")],
}

# Contact cleanup mode of each robot (`_select_bottom_points`)
_CLEANUP = {"cassie": "bottom4", "digit": "bottom4", "atlas": "hull"}


def load_robot(name: str, has_freeflyer: Optional[bool] = None, lock_joints=None) -> Robot:
    """Build the named packaged robot from its vendored reference assets.
    ``lock_joints`` folds movable joints away (names, or ``{name: angle}``;
    by default the robot's passive joints); the motors and sensors on them
    are dropped."""
    if has_freeflyer is None:
        has_freeflyer = name in ("anymal", "atlas", "cassie", "digit")
    if lock_joints is None:
        lock_joints = _LOCKED_JOINTS.get(name, ())
    hw_file = hardware_path(name)
    hw = load_hardware_description_file(hw_file) if hw_file else {}
    model = build_model_from_urdf(urdf_path(name), has_freeflyer=has_freeflyer,
                                  lock_joints=lock_joints)

    # The pushrod frames of the loop closures
    for fname, parent, xyz in _PUSHRODS.get(name, ()):
        if parent in model.joint_names:
            # a movable joint's name is its moving frame (identity placement)
            parent_joint, rot, pos = model.joint_index(parent), np.eye(3), np.asarray(xyz, float)
        else:
            pf = model.frame_index(parent)
            parent_joint = model.frame_parents[pf]
            rot = np.asarray(model.fplacement_rot[pf], float)
            pos = np.asarray(model.fplacement_pos[pf], float) + rot @ np.asarray(xyz, float)
        model = model.add_frame(fname, parent_joint, rot, pos)

    # Collision bodies -> contact points, pruned at the nominal pose
    nominal = nominal_pose(name, model)
    collision_specs: list = []
    for body in hw.get("collision_bodies", ()):
        keep, points = _collision_body_specs(name, body)
        collision_specs += [dict(spec) for spec in keep]
        points = [p.copy() for p in points]
        if points:
            points = _select_bottom_points(model, nominal, body, points, _CLEANUP.get(name))
            collision_specs.append(
                {"frame_name": body, "geometry": "points", "points": np.stack(points),
                 "max_points": len(points)}
            )

    # Drop hardware attached to locked-away joints (the reference skips them
    # when loading hardware onto a reduced model)
    motors = [m for m in hw.get("motors", []) if m["joint_name"] in model.joint_names]
    motor_names = {m["name"] for m in motors}
    sensors = {}
    for kind, specs in hw.get("sensors", {}).items():
        kept = [
            s for s in specs
            if not ("motor_name" in s and s["motor_name"] not in motor_names)
            and not ("joint_name" in s and s["joint_name"] not in model.joint_names)
        ]
        if kept:
            sensors[kind] = kept
    return Robot.build(
        model,
        name=name,
        motors=motors,
        sensors=sensors,
        contact_frames=hw.get("contact_frames", ()),
        collision_bodies=collision_specs,
        loop_constraints=_LOOP_PAIRS.get(name, ()),
    )
