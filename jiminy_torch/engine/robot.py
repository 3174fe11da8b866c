"""Robot = model + motors + sensors + contact frames (port of
`jiminy_tpu.engine.robot`).

This slice assembles motors (armature folded onto the model diagonal),
encoder, effort, IMU and force sensors, and point contact frames. Flexibility
and backlash joints and collision bodies/pairs are refused with the
ROADMAP.md item that will port them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from jiminy_torch.engine.hardware import (
    EffortSensorGroup,
    EncoderSensorGroup,
    ForceSensorGroup,
    ImuSensorGroup,
    MotorBank,
    SensorSuite,
    build_motor_bank,
)
from jiminy_torch.models.model import RobotModel
from jiminy_torch.models.urdf import build_model_from_urdf


@dataclasses.dataclass(eq=False)
class Robot:
    name: str
    model: RobotModel
    motors: Optional[MotorBank] = None
    sensors: SensorSuite = dataclasses.field(default_factory=SensorSuite)
    contact_frame_indices: tuple = ()
    contact_radii: tuple = ()

    @property
    def nq(self):
        return self.model.nq

    @property
    def nv(self):
        return self.model.nv

    @property
    def nmotors(self):
        return 0 if self.motors is None else self.motors.nmotors

    @staticmethod
    def build(
        model_or_urdf,
        has_freeflyer: bool = False,
        name: Optional[str] = None,
        motors: Sequence[dict] = (),
        sensors: Optional[dict] = None,
        contact_frames: Sequence[str] = (),
        collision_bodies: Sequence = (),
        flexibility: Sequence[dict] = (),
        loop_constraints: Sequence[tuple] = (),
        collision_pairs: Sequence[tuple] = (),
        lock_joints: Sequence[str] = (),
    ) -> "Robot":
        """Assemble a robot from a RobotModel or a URDF (path or XML string)."""
        if flexibility:
            raise NotImplementedError(
                "flexibility joints are not ported yet (ROADMAP.md queue 1 item 11)"
            )
        if collision_bodies or collision_pairs:
            raise NotImplementedError(
                "collision bodies and collision pairs are not ported yet "
                "(ROADMAP.md queue 1 item 10)"
            )
        if loop_constraints:
            raise NotImplementedError(
                "loop closures are not ported yet (ROADMAP.md queue 1 item 10)"
            )
        if isinstance(model_or_urdf, RobotModel):
            model = model_or_urdf
        else:
            model = build_model_from_urdf(model_or_urdf, has_freeflyer, lock_joints=lock_joints)
        name = name or model.name

        bank = build_motor_bank(model, motors) if motors else None
        if bank is not None and np.any(bank.backlash > 0.0):
            raise NotImplementedError(
                "motor backlash joints are not ported yet (ROADMAP.md queue 1 item 11)"
            )
        if bank is not None and bank.nmotors:
            # Fold joint-side armature (rotor inertia * reduction^2) into the model
            arm = np.array(model.armature, dtype=np.float64)
            for i, vi in enumerate(bank.v_indices):
                arm[vi] += float(bank.armature[i]) * float(bank.mechanical_reduction[i]) ** 2
            model = model.replace(armature=arm)

        contact_idx = tuple(model.frame_index(fn) for fn in contact_frames)
        suite = _build_sensor_suite(model, bank, sensors or {}, contact_idx)
        return Robot(
            name=name,
            model=model,
            motors=bank,
            sensors=suite,
            contact_frame_indices=contact_idx,
            contact_radii=(0.0,) * len(contact_idx),
        )


def _opt_arrays(n, ndata, specs):
    noise = np.zeros((n, ndata))
    bias = np.zeros((n, ndata))
    delay = np.zeros((n,))
    jitter = np.zeros((n,))
    for i, s in enumerate(specs):
        noise[i] = np.broadcast_to(np.asarray(s.get("noise_std", 0.0), dtype=float), (ndata,))
        bias[i] = np.broadcast_to(np.asarray(s.get("bias", 0.0), dtype=float), (ndata,))
        delay[i] = float(s.get("delay", 0.0))
        jitter[i] = float(s.get("jitter", 0.0))
    return noise, bias, delay, jitter


def _build_sensor_suite(model, bank, sensor_specs, contact_idx) -> SensorSuite:
    if sensor_specs.get("contact"):
        raise NotImplementedError(
            "contact sensors are not ported yet (ROADMAP.md queue 1 item 11)"
        )
    suite = {}

    enc_specs = sensor_specs.get("encoder", ())
    if enc_specs:
        names, qidx, vidx, types, side, reds = [], [], [], [], [], []
        for s in enc_specs:
            if "motor_name" in s and bank is not None:
                m = bank.names.index(s["motor_name"])
                j = bank.joint_indices[m]
                red = float(bank.mechanical_reduction[m])
                joint_side = bool(s.get("joint_side", False))
            else:
                j = model.joint_index(s["joint_name"])
                red = 1.0
                joint_side = True
            names.append(s.get("name", model.joint_names[j]))
            qidx.append(model.idx_q[j])
            vidx.append(model.idx_v[j])
            types.append(int(model.joint_types[j]))
            side.append(joint_side)
            reds.append(red)
        noise, bias, delay, jitter = _opt_arrays(len(names), 2, enc_specs)
        suite["encoder"] = EncoderSensorGroup(
            names=tuple(names),
            q_indices=tuple(qidx),
            v_indices=tuple(vidx),
            joint_types=tuple(types),
            joint_side=tuple(side),
            reduction=np.array(reds),
            noise_std=noise,
            bias=bias,
            delay=delay,
            jitter=jitter,
        )

    eff_specs = sensor_specs.get("effort", ())
    if eff_specs:
        names = [s.get("name", s["motor_name"]) for s in eff_specs]
        midx = tuple(bank.names.index(s["motor_name"]) for s in eff_specs)
        noise, bias, delay, jitter = _opt_arrays(len(names), 1, eff_specs)
        suite["effort"] = EffortSensorGroup(
            names=tuple(names),
            motor_indices=midx,
            noise_std=noise,
            bias=bias,
            delay=delay,
            jitter=jitter,
        )

    imu_specs = sensor_specs.get("imu", ())
    if imu_specs:
        names = [s.get("name", s["frame_name"]) for s in imu_specs]
        fidx = tuple(model.frame_index(s["frame_name"]) for s in imu_specs)
        n = len(names)
        if any(np.any(np.asarray(s.get("bias", 0.0)) != 0.0) for s in imu_specs):
            raise NotImplementedError(
                "IMU bias is not ported yet (ROADMAP.md queue 1 item 11)"
            )
        noise, bias, delay, jitter = _opt_arrays(n, 6, imu_specs)
        suite["imu"] = ImuSensorGroup(
            names=tuple(names),
            frame_indices=fidx,
            rot_bias_inv=np.tile(np.eye(3), (n, 1, 1)),
            noise_std=noise,
            bias=bias,
            delay=delay,
            jitter=jitter,
        )

    frc_specs = sensor_specs.get("force", ())
    if frc_specs:
        names = [s.get("name", s["frame_name"]) for s in frc_specs]
        fidx = tuple(model.frame_index(s["frame_name"]) for s in frc_specs)
        slots = tuple(
            tuple(
                k
                for k, c in enumerate(contact_idx)
                if model.frame_parents[c] == model.frame_parents[f]
            )
            for f in fidx
        )
        noise, bias, delay, jitter = _opt_arrays(len(names), 6, frc_specs)
        suite["force"] = ForceSensorGroup(
            names=tuple(names),
            frame_indices=fidx,
            contact_slots=slots,
            noise_std=noise,
            bias=bias,
            delay=delay,
            jitter=jitter,
        )
    return SensorSuite(**suite)
