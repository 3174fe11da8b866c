"""Packaged robots built from the vendored reference asset files (port of
`jiminy_tpu.envs.assets`).

The URDF and `*_hardware.toml` files are read as data from the JAX package's
data directory; nothing of that package is imported. This slice loads the
robots whose hardware declares point contact frames only (ANYmal); collision
bodies, locked passive joints and loop closures wait for ROADMAP.md queue 1
item 10 (bipeds).
"""

from __future__ import annotations

import os
from typing import Optional

from jiminy_torch.engine.robot import Robot
from jiminy_torch.hardware import load_hardware_description_file
from jiminy_torch.models.urdf import build_model_from_urdf

DATA_DIR = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "jiminy_tpu", "data")
)

_ASSET_SUBDIRS = {
    "anymal": "quadrupedal_robots/anymal",
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


def load_robot(name: str, has_freeflyer: Optional[bool] = None) -> Robot:
    """Build the named packaged robot from its vendored reference assets."""
    if has_freeflyer is None:
        has_freeflyer = name == "anymal"
    hw_file = hardware_path(name)
    hw = load_hardware_description_file(hw_file) if hw_file else {}
    model = build_model_from_urdf(urdf_path(name), has_freeflyer=has_freeflyer)
    motors = [m for m in hw.get("motors", []) if m["joint_name"] in model.joint_names]
    return Robot.build(
        model,
        name=name,
        motors=motors,
        sensors=hw.get("sensors", {}),
        contact_frames=hw.get("contact_frames", ()),
        collision_bodies=hw.get("collision_bodies", ()),
        loop_constraints=hw.get("loop_constraints", ()),
    )
