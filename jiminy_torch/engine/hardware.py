"""Hardware models: the motor bank and the typed sensor groups (port of
`jiminy_tpu.engine.hardware`).

Each family is a struct of host float64 arrays whose update is one batched
torch op across all instances and all environments. This slice ports the
delay-free, noise-free read-outs (`compute_raw`) of the encoder, effort, IMU
and force groups; sensor delay lines, jitter, noise and bias wait for
ROADMAP.md queue 1 item 11, and the engine refuses a robot that declares them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from jiminy_torch.models import joints as jt
from jiminy_torch.models.model import RobotModel
from jiminy_torch.ops import lie
from jiminy_torch.ops.kinematics import (
    KinData,
    frame_classical_acceleration_local,
    frame_placement,
    frame_velocity_local,
)


class _Placed:
    """Caches host arrays placed on a device in a dtype."""

    def tensor(self, field: str, device, dtype) -> torch.Tensor:
        cache = self.__dict__.setdefault("_placed", {})
        key = (field, torch.device(device), dtype)
        t = cache.get(key)
        if t is None:
            t = torch.as_tensor(np.asarray(getattr(self, field)), dtype=dtype, device=device)
            cache[key] = t
        return t


# =============================================================================
# Motors
# =============================================================================

MOTOR_ARRAY_FIELDS = (
    "mechanical_reduction",
    "effort_limit",
    "velocity_limit",
    "velocity_effort_inv_slope",
    "armature",
    "backlash",
    "friction_viscous_pos",
    "friction_viscous_neg",
    "friction_dry_pos",
    "friction_dry_neg",
    "friction_dry_slope",
    "enable_effort_limit",
    "enable_velocity_limit",
    "enable_friction",
)


@dataclasses.dataclass(eq=False)
class MotorBank(_Placed):
    """All motors of one robot, struct-of-arrays (reference `SimpleMotor`,
    `basic_motors.cc:100-143`). Friction coefficients are <= 0 and added."""

    names: tuple
    joint_indices: tuple
    v_indices: tuple
    q_indices: tuple
    mechanical_reduction: np.ndarray
    effort_limit: np.ndarray  # motor-side
    velocity_limit: np.ndarray  # motor-side
    velocity_effort_inv_slope: np.ndarray
    armature: np.ndarray
    backlash: np.ndarray
    friction_viscous_pos: np.ndarray
    friction_viscous_neg: np.ndarray
    friction_dry_pos: np.ndarray
    friction_dry_neg: np.ndarray
    friction_dry_slope: np.ndarray
    enable_effort_limit: np.ndarray  # 0/1
    enable_velocity_limit: np.ndarray  # 0/1
    enable_friction: np.ndarray  # 0/1

    @property
    def nmotors(self) -> int:
        return len(self.names)

    def compute_efforts(self, command: torch.Tensor, v: torch.Tensor):
        """Motor commands -> (u_motor (..., nm), transmission torques (..., nv))."""

        def t(name):
            return self.tensor(name, command.device, command.dtype)

        vidx = self.tensor("v_indices", v.device, torch.long)
        v_joint = torch.index_select(v, -1, vidx)
        red, el, vl = t("mechanical_reduction"), t("effort_limit"), t("velocity_limit")
        v_motor = red * v_joint
        en_e = t("enable_effort_limit") > 0
        effort_min = torch.where(en_e, -el, -math.inf)
        effort_max = torch.where(en_e, el, math.inf)
        el_fin = torch.where(torch.isfinite(el), el, 0.0)
        vl_fin = torch.where(torch.isfinite(vl), vl, 0.0)
        vel_delta = el_fin * t("velocity_effort_inv_slope")
        vel_thr = torch.clamp_min(vl_fin - vel_delta, 0.0)
        denom = torch.clamp_min(vl_fin - vel_thr, 1e-12)
        scale_min = torch.clamp((vl_fin + v_motor) / denom, 0.0, 1.0)
        scale_max = torch.clamp((vl_fin - v_motor) / denom, 0.0, 1.0)
        apply_env = (
            en_e
            & (t("enable_velocity_limit") > 0)
            & (vel_delta > 0.0)
            & torch.isfinite(el)
            & torch.isfinite(vl)
        )
        effort_min = torch.where(apply_env, -el_fin * scale_min, effort_min)
        effort_max = torch.where(apply_env, el_fin * scale_max, effort_max)
        u_motor = torch.clamp(command, effort_min, effort_max)
        u_trans = red * u_motor
        fric = torch.where(
            v_joint > 0.0,
            t("friction_viscous_pos") * v_joint
            + t("friction_dry_pos") * torch.tanh(t("friction_dry_slope") * v_joint),
            t("friction_viscous_neg") * v_joint
            + t("friction_dry_neg") * torch.tanh(t("friction_dry_slope") * v_joint),
        )
        u_trans = u_trans + torch.where(t("enable_friction") > 0, fric, 0.0)
        u_full = torch.zeros(u_trans.shape[:-1] + v.shape[-1:], dtype=v.dtype, device=v.device)
        u_full.index_add_(-1, vidx, u_trans)
        return u_motor, u_full


def build_motor_bank(model: RobotModel, motor_specs) -> MotorBank:
    """Motor specs {joint_name, [mechanical_reduction], [armature], ...};
    limits default to the model's URDF values converted motor-side."""
    names, jidx, vidx, qidx = [], [], [], []
    cols = {k: [] for k in MOTOR_ARRAY_FIELDS}
    for spec in motor_specs:
        j = model.joint_index(spec["joint_name"])
        t = jt.JointType(model.joint_types[j])
        if jt.JOINT_NV[t] != 1:
            raise ValueError(f"motors only attach to 1-dof joints, got {t} for {spec}")
        names.append(spec.get("name", spec["joint_name"]))
        jidx.append(j)
        vidx.append(model.idx_v[j])
        qidx.append(model.idx_q[j])
        red = float(spec.get("mechanical_reduction", 1.0))
        eff_joint = float(model.effort_limit[model.idx_v[j]])
        vel_joint = float(model.velocity_limit[model.idx_v[j]])
        cols["mechanical_reduction"].append(red)
        cols["effort_limit"].append(float(spec.get("effort_limit", eff_joint / max(red, 1e-12))))
        cols["velocity_limit"].append(float(spec.get("velocity_limit", vel_joint * red)))
        cols["velocity_effort_inv_slope"].append(float(spec.get("velocity_effort_inv_slope", 0.0)))
        cols["armature"].append(float(spec.get("armature", 0.0)))
        cols["backlash"].append(float(spec.get("backlash", 0.0)))
        cols["friction_viscous_pos"].append(float(spec.get("friction_viscous_pos", 0.0)))
        cols["friction_viscous_neg"].append(float(spec.get("friction_viscous_neg", 0.0)))
        cols["friction_dry_pos"].append(float(spec.get("friction_dry_pos", 0.0)))
        cols["friction_dry_neg"].append(float(spec.get("friction_dry_neg", 0.0)))
        cols["friction_dry_slope"].append(float(spec.get("friction_dry_slope", 20.0)))
        cols["enable_effort_limit"].append(float(bool(spec.get("enable_effort_limit", True))))
        cols["enable_velocity_limit"].append(float(bool(spec.get("enable_velocity_limit", False))))
        cols["enable_friction"].append(float(bool(spec.get("enable_friction", False))))
    return MotorBank(
        names=tuple(names),
        joint_indices=tuple(jidx),
        v_indices=tuple(vidx),
        q_indices=tuple(qidx),
        **{k: np.array(v, dtype=np.float64) for k, v in cols.items()},
    )


# =============================================================================
# Sensors (delay-free, noise-free read-outs)
# =============================================================================


class _GroupBase(_Placed):
    fieldnames: tuple = ()

    @property
    def nsensors(self) -> int:
        return len(self.names)

    def is_clean(self) -> bool:
        """No noise, bias, delay or jitter: the measurement is the raw value."""
        return not any(
            np.any(np.asarray(getattr(self, f)) != 0.0)
            for f in ("noise_std", "bias", "delay", "jitter")
        )


@dataclasses.dataclass(eq=False)
class EncoderSensorGroup(_GroupBase):
    """Q, V of a motor or joint (reference `basic_sensors.cc:509-539`)."""

    fieldnames = ("Q", "V")
    names: tuple
    q_indices: tuple
    v_indices: tuple
    joint_types: tuple
    joint_side: tuple  # bool per sensor
    reduction: np.ndarray
    noise_std: np.ndarray
    bias: np.ndarray
    delay: np.ndarray
    jitter: np.ndarray

    def compute_raw(self, model, kin, q, v, a, u_motor, contact_f) -> torch.Tensor:
        red = self.tensor("reduction", q.device, q.dtype)
        out = []
        for i in range(self.nsensors):
            qi = self.q_indices[i]
            if jt.JointType(self.joint_types[i]) == jt.JointType.REVOLUTE_UNBOUNDED:
                pos = torch.atan2(q[..., qi + 1], q[..., qi])  # (cos, sin) -> angle
            else:
                pos = q[..., qi]
            vel = v[..., self.v_indices[i]]
            if not self.joint_side[i]:
                pos = pos * red[i]
                vel = vel * red[i]
            out.append(torch.stack([pos, vel], dim=-1))
        return torch.stack(out, dim=-2)


@dataclasses.dataclass(eq=False)
class EffortSensorGroup(_GroupBase):
    """Motor effort U."""

    fieldnames = ("U",)
    names: tuple
    motor_indices: tuple
    noise_std: np.ndarray
    bias: np.ndarray
    delay: np.ndarray
    jitter: np.ndarray

    def compute_raw(self, model, kin, q, v, a, u_motor, contact_f) -> torch.Tensor:
        idx = torch.as_tensor(self.motor_indices, dtype=torch.long, device=u_motor.device)
        return torch.index_select(u_motor, -1, idx)[..., None]


@dataclasses.dataclass(eq=False)
class ImuSensorGroup(_GroupBase):
    """Gyroscope + accelerometer at a frame (reference `basic_sensors.cc:142-188`):
    gyro = LOCAL angular velocity; accel = classical linear acceleration minus
    gravity, LOCAL frame."""

    fieldnames = ("GyroX", "GyroY", "GyroZ", "AccelX", "AccelY", "AccelZ")
    names: tuple
    frame_indices: tuple
    rot_bias_inv: np.ndarray
    noise_std: np.ndarray
    bias: np.ndarray
    delay: np.ndarray
    jitter: np.ndarray

    def is_clean(self) -> bool:
        return super().is_clean() and bool(
            np.all(np.asarray(self.rot_bias_inv) == np.eye(3))
        )

    def compute_raw(self, model, kin: KinData, q, v, a, u_motor, contact_f) -> torch.Tensor:
        gravity = contact_f["gravity"]
        out = []
        for fidx in self.frame_indices:
            vel = frame_velocity_local(model, kin, fidx)
            acc = frame_classical_acceleration_local(model, kin, fidx)
            rot, _ = frame_placement(model, kin, fidx)
            accel = acc[..., 3:] - lie.mv(rot.transpose(-1, -2), gravity)
            out.append(torch.cat([vel[..., :3], accel], dim=-1))
        return torch.stack(out, dim=-2)


@dataclasses.dataclass(eq=False)
class ForceSensorGroup(_GroupBase):
    """6D wrench at a frame = sum of the contact wrenches on the same parent
    joint, transported to the sensor frame (reference `basic_sensors.cc:368-387`)."""

    fieldnames = ("FX", "FY", "FZ", "MX", "MY", "MZ")
    names: tuple
    frame_indices: tuple
    contact_slots: tuple  # per sensor: contact slots sharing its parent joint
    noise_std: np.ndarray
    bias: np.ndarray
    delay: np.ndarray
    jitter: np.ndarray

    def compute_raw(self, model, kin, q, v, a, u_motor, contact_f) -> torch.Tensor:
        wrench = contact_f["contact_wrench_local"]  # (..., nc, 6) (ang, lin)
        contact_frames = contact_f["contact_frame_indices"]
        dev, dt = wrench.device, wrench.dtype
        frot = model.tensor("fplacement_rot", dev, dt)
        fpos = model.tensor("fplacement_pos", dev, dt)
        out = []
        for i, slots in enumerate(self.contact_slots):
            fs = self.frame_indices[i]
            inv_rot, inv_pos = lie.se3_inv(frot[fs], fpos[fs])
            acc = None
            for s in slots:
                fc = contact_frames[s]
                x_rot, x_pos = lie.se3_mul(inv_rot, inv_pos, frot[fc], fpos[fc])
                w = lie.force_act(x_rot, x_pos, wrench[..., s, :])
                acc = w if acc is None else acc + w
            if acc is None:
                acc = torch.zeros(wrench.shape[:-2] + (6,), dtype=dt, device=dev)
            out.append(torch.cat([acc[..., 3:], acc[..., :3]], dim=-1))
        return torch.stack(out, dim=-2)


@dataclasses.dataclass(eq=False)
class SensorSuite:
    """All sensor groups of one robot; iteration order is the telemetry order."""

    encoder: Optional[EncoderSensorGroup] = None
    effort: Optional[EffortSensorGroup] = None
    imu: Optional[ImuSensorGroup] = None
    force: Optional[ForceSensorGroup] = None

    def groups(self):
        for name in ("encoder", "effort", "imu", "force"):
            g = getattr(self, name)
            if g is not None and g.nsensors > 0:
                yield name, g
