"""Packaged robots built from the vendored reference asset files (port of
`jiminy_tpu.envs.assets`).

The URDF and `*_hardware.toml` files are read as data from the JAX package's
data directory; nothing of that package is imported. This slice loads the
toys (cartpole, acrobot, simple_pendulum: fixed base, no hardware file),
the ANYmal (point contact frames) and Atlas (foot collision boxes expanded
into corner contact points, pruned to the support hull at the nominal pose;
locked joints folded away); collision meshes and the Cassie/Digit pushrod
loop closures wait for ROADMAP.md queue 1 item 10.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from jiminy_torch.engine.robot import Robot, box_corners
from jiminy_torch.hardware import load_hardware_description_file
from jiminy_torch.models import joints as jt
from jiminy_torch.models.urdf import build_model_from_urdf, parse_collision_geometries
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
}

# Robots whose collision bodies' candidate points are pruned to their
# support hull at the nominal pose (`_hull_points`)
_HULL_CLEANUP = ("atlas",)


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


def _collision_body_specs(name: str, body: str) -> tuple[list, list]:
    """(collision_specs, candidate_points) for one collision body: boxes are
    replaced by their corner points (offsets in the LINK frame); other
    primitives stay collision specs; a body with no geometry gets one point
    at its frame. Meshes raise (`parse_collision_geometries`)."""
    cols = parse_collision_geometries(urdf_path(name), links=(body,)).get(body, [])
    keep_specs = [s for s in cols if s["geometry"] != "box"]
    points: list = []
    for s in cols:
        if s["geometry"] == "box":
            rot, pos = (np.asarray(x, float) for x in s["origin"])
            points += [pos + rot @ c for c in box_corners(s["size"])]
    if not keep_specs and not points:
        points.append(np.zeros(3))
    return keep_specs, points


def _hull_points(model, nominal_q, body, points) -> list:
    """The candidate points kept on the support hull (reference
    `atlas.py:100-112` `_cleanup_contact_points`): the lower half at the
    nominal pose, then the vertices of its 2D convex hull."""
    if len(points) <= 4:
        return points
    kin = forward_kinematics(model, torch.as_tensor(nominal_q, dtype=torch.float64))
    rot, pos = frame_placement(model, kin, model.frame_index(body))
    rot, pos = rot.numpy(), pos.numpy()
    world = np.stack([pos + rot @ p for p in points])
    bottom = np.argsort(world[:, 2])[: max(len(points) // 2, 3)]
    try:
        from scipy.spatial import ConvexHull

        keep = bottom[np.unique(ConvexHull(world[bottom, :2]).vertices)]
    except Exception:  # a degenerate footprint keeps the lower half
        keep = bottom
    return [points[i] for i in keep]


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
    return _atlas_posed(model, q) if name == "atlas" else q


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


def load_robot(name: str, has_freeflyer: Optional[bool] = None, lock_joints=()) -> Robot:
    """Build the named packaged robot from its vendored reference assets.
    ``lock_joints`` folds movable joints away (names, or ``{name: angle}``);
    the motors and sensors on them are dropped."""
    if has_freeflyer is None:
        has_freeflyer = name in ("anymal", "atlas")
    hw_file = hardware_path(name)
    hw = load_hardware_description_file(hw_file) if hw_file else {}
    model = build_model_from_urdf(urdf_path(name), has_freeflyer=has_freeflyer,
                                  lock_joints=lock_joints)

    # Collision bodies -> contact points, pruned at the nominal pose
    collision_specs: list = []
    for body in hw.get("collision_bodies", ()):
        keep, points = _collision_body_specs(name, body)
        collision_specs += keep
        if points:
            if name in _HULL_CLEANUP:
                points = _hull_points(model, nominal_pose(name, model), body, points)
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
        loop_constraints=hw.get("loop_constraints", ()),
    )
