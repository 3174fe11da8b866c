"""Hardware description files: TOML declaration of motors, sensors and
contacts (port of `jiminy_tpu.hardware.load_hardware_description_file`).

Accepts both the package's snake_case schema and the reference's native
schema (`contactFrameNames`/`collisionBodyNames` globals, camelCase motor
options), so the vendored asset files load unmodified.
"""

from __future__ import annotations

import tomllib

_SENSOR_KIND = {
    "ImuSensor": "imu",
    "EncoderSensor": "encoder",
    "EffortSensor": "effort",
    "ContactSensor": "contact",
    "ForceSensor": "force",
}

_MOTOR_KEY_MAP = {
    "mechanicalReduction": "mechanical_reduction",
    "effortLimit": "effort_limit",
    "velocityLimit": "velocity_limit",
    "enableEffortLimit": "enable_effort_limit",
    "enableVelocityLimit": "enable_velocity_limit",
    "velocityEffortInvSlope": "velocity_effort_inv_slope",
    "enableFriction": "enable_friction",
    "frictionViscousPositive": "friction_viscous_pos",
    "frictionViscousNegative": "friction_viscous_neg",
    "frictionDryPositive": "friction_dry_pos",
    "frictionDryNegative": "friction_dry_neg",
    "frictionDrySlope": "friction_dry_slope",
    "enableBacklash": "enable_backlash",
    "backlash": "backlash",
}


def load_hardware_description_file(path: str) -> dict:
    """Parse a `*_hardware.toml` into `Robot.build` keyword arguments."""
    with open(path, "rb") as f:
        data = tomllib.load(f)
    out: dict = {
        "motors": [],
        "sensors": {},
        "contact_frames": [],
        "collision_bodies": [],
        "flexibility": [],
        "loop_constraints": [],
        "extra": {},
    }
    if "has_freeflyer" in data:
        out["has_freeflyer"] = bool(data["has_freeflyer"])
    glob = dict(data.get("Global", {}))
    out["contact_frames"] = list(
        glob.pop("contact_frames", None) or glob.pop("contactFrameNames", [])
    )
    out["loop_constraints"] = [tuple(p) for p in glob.pop("loop_constraints", [])]
    out["collision_bodies"] = list(
        glob.pop("collision_bodies", None) or glob.pop("collisionBodyNames", [])
    )
    out["extra"] = glob

    for _kind, motors in data.get("Motor", {}).items():
        for name, spec in motors.items():
            spec = {_MOTOR_KEY_MAP.get(k, k): v for k, v in spec.items()}
            spec.setdefault("name", name)
            spec.setdefault("joint_name", name)
            if not spec.pop("enable_backlash", True):
                spec.pop("backlash", None)
            out["motors"].append(spec)

    for sensor_type, sensors in data.get("Sensor", {}).items():
        kind = _SENSOR_KIND.get(sensor_type)
        if kind is None:
            raise ValueError(f"unknown sensor type {sensor_type}")
        lst = out["sensors"].setdefault(kind, [])
        for name, spec in sensors.items():
            spec = dict(spec)
            spec.setdefault("name", name)
            lst.append(spec)

    for name, spec in data.get("Flexibility", {}).items():
        spec = dict(spec)
        spec.setdefault("joint_name", name)
        out["flexibility"].append(spec)
    return out
