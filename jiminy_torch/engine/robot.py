"""Robot = model + motors + sensors + contact frames (port of
`jiminy_tpu.engine.robot`).

This slice assembles motors (armature folded onto the model diagonal),
encoder, effort, IMU and force sensors, point contact frames, collision
bodies expanded into contact points (a sphere one radius-r point, a capsule
two, boxes, cylinder rims and point clouds radius-0 points), loop closures
(distance constraints between two frames, `loop_pairs`) and rolling
constraints (`rolling_specs`: a sphere or a wheel on a frame). Flexibility
and backlash joints and collision pairs are refused with the ROADMAP.md
item that will port them.
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
from jiminy_torch.models.urdf import build_model_from_urdf, parse_collision_geometries


@dataclasses.dataclass(eq=False)
class Robot:
    name: str
    model: RobotModel
    motors: Optional[MotorBank] = None
    sensors: SensorSuite = dataclasses.field(default_factory=SensorSuite)
    contact_frame_indices: tuple = ()
    contact_radii: tuple = ()
    # Closed kinematic loops: ((frame_a, frame_b), ...) distance constraints
    loop_pairs: tuple = ()
    # Rolling constraints: ((frame_name, radius, axis or None), ...); None is
    # a sphere, an axis (in the frame) a wheel
    rolling_specs: tuple = ()

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
        rolling_constraints: Sequence[dict] = (),
        collision_pairs: Sequence[tuple] = (),
        lock_joints: Sequence[str] = (),
    ) -> "Robot":
        """Assemble a robot from a RobotModel or a URDF (path or XML string)."""
        if flexibility:
            raise NotImplementedError(
                "flexibility joints are not ported yet (ROADMAP.md queue 1 item 11)"
            )
        if collision_pairs:
            raise NotImplementedError(
                "collision pairs are not ported yet (ROADMAP.md queue 1 item 10)"
            )
        if isinstance(model_or_urdf, RobotModel):
            model = model_or_urdf
        else:
            model = build_model_from_urdf(model_or_urdf, has_freeflyer, lock_joints=lock_joints)
        if any(isinstance(cb, str) for cb in collision_bodies):
            # Link names: their <collision> geometries from the URDF
            # (hardware-file `collisionBodyNames`)
            if isinstance(model_or_urdf, RobotModel):
                raise ValueError("collision_bodies by link name require building from URDF")
            geoms = parse_collision_geometries(model_or_urdf)
            expanded: list = []
            for cb in collision_bodies:
                if not isinstance(cb, str):
                    expanded.append(cb)
                elif cb in geoms:
                    expanded.extend(geoms[cb])
                else:
                    raise ValueError(f"link '{cb}' has no <collision> geometry in the URDF")
            collision_bodies = expanded
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
        radii = [0.0] * len(contact_idx)
        if collision_bodies:
            model, extra_idx, extra_radii = _expand_collision_bodies(model, collision_bodies)
            contact_idx = contact_idx + extra_idx
            radii += extra_radii
        suite = _build_sensor_suite(model, bank, sensors or {}, contact_idx)
        return Robot(
            name=name,
            model=model,
            motors=bank,
            sensors=suite,
            contact_frame_indices=contact_idx,
            contact_radii=tuple(radii),
            loop_pairs=tuple(tuple(p) for p in loop_constraints),
            rolling_specs=tuple(
                (r["frame_name"], float(r["radius"]), tuple(r["axis"]) if "axis" in r else None)
                for r in rolling_constraints
            ),
        )


def _hull_downsample(points: np.ndarray, max_points: int) -> np.ndarray:
    """A vertex cloud reduced to its convex-hull vertices, then (if still too
    many) to a farthest-point subset of `max_points` seeded at the lowest
    vertex. Only hull vertices can touch a locally planar ground."""
    points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    if len(points) > 4:
        try:
            from scipy.spatial import ConvexHull

            points = points[np.unique(ConvexHull(points).vertices)]
        except Exception:  # a flat or degenerate cloud keeps every point
            pass
    if len(points) <= max_points:
        return points
    chosen = [int(np.argmin(points[:, 2]))]
    d = np.linalg.norm(points - points[chosen[0]], axis=1)
    for _ in range(max_points - 1):
        nxt = int(np.argmax(d))
        chosen.append(nxt)
        d = np.minimum(d, np.linalg.norm(points - points[nxt], axis=1))
    return points[chosen]


def box_corners(size) -> list:
    """The 8 corners of a box of edge lengths `size`, centred at the origin."""
    sx, sy, sz = (0.5 * float(s) for s in size)
    return [
        np.array([ex * sx, ey * sy, ez * sz])
        for ex in (-1.0, 1.0)
        for ey in (-1.0, 1.0)
        for ez in (-1.0, 1.0)
    ]


def _unit(axis) -> np.ndarray:
    axis = np.asarray(axis, float)
    return axis / max(np.linalg.norm(axis), 1e-12)


def _geometry_points(spec) -> list:
    """Contact points (offset in the geometry's frame, radius) of a
    collision body: a sphere one radius-r point at its centre, a capsule a
    radius-r point at each segment end, a box its 8 corners, a cylinder
    `n_rim` (default 8) points on each end rim, a point cloud its hull
    vertices (at most `max_points`, default 16); all but the first two of
    radius 0."""
    geom = spec["geometry"]
    if geom == "sphere":
        return [(np.zeros(3), float(spec["radius"]))]
    if geom == "capsule":
        half = 0.5 * float(spec["length"]) * _unit(spec.get("axis", (0.0, 0.0, 1.0)))
        return [(half, float(spec["radius"])), (-half, float(spec["radius"]))]
    if geom == "box":
        return [(c, 0.0) for c in box_corners(spec["size"])]
    if geom == "cylinder":
        axis = _unit(spec.get("axis", (0.0, 0.0, 1.0)))
        half = 0.5 * float(spec["length"])
        rad = float(spec["radius"])
        # Orthonormal basis of the rim plane
        ref = np.array([1.0, 0.0, 0.0])
        if abs(axis @ ref) > 0.9:
            ref = np.array([0.0, 1.0, 0.0])
        u = np.cross(axis, ref)
        u /= np.linalg.norm(u)
        w = np.cross(axis, u)
        return [
            (end * half * axis + rad * (np.cos(a) * u + np.sin(a) * w), 0.0)
            for end in (-1.0, 1.0)
            for a in np.linspace(0.0, 2.0 * np.pi, int(spec.get("n_rim", 8)), endpoint=False)
        ]
    if geom in ("mesh", "points"):
        pts = _hull_downsample(spec["points"], int(spec.get("max_points", 16)))
        return [(p, 0.0) for p in pts]
    raise ValueError(f"unsupported collision geometry '{geom}'")


def _expand_collision_bodies(model: RobotModel, specs) -> tuple:
    """Collision bodies expanded into contact frames on the body's parent
    joint, named `<body>_collision_<k>` (`<body>_collision` for a body's
    only point): (model with the frames, their indices, their radii). Each
    spec may carry an `origin` (rot, pos) of the geometry in its frame."""
    idx: list = []
    radii: list = []
    used: dict = {}
    for spec in specs:
        fname = spec["frame_name"]
        fidx = model.frame_index(fname)
        parent = model.frame_parents[fidx]
        rot0 = np.asarray(model.fplacement_rot[fidx], np.float64)
        pos0 = np.asarray(model.fplacement_pos[fidx], np.float64)
        o_rot, o_pos = spec.get("origin", (np.eye(3), np.zeros(3)))
        rot0, pos0 = rot0 @ np.asarray(o_rot, float), pos0 + rot0 @ np.asarray(o_pos, float)
        points = _geometry_points(spec)
        base = used.get(fname, 0)
        used[fname] = base + len(points)
        single = len(points) == 1 and base == 0
        for k, (off, r) in enumerate(points):
            pname = f"{fname}_collision" if single else f"{fname}_collision_{base + k}"
            model = model.add_frame(pname, parent, rot0, pos0 + rot0 @ off)
            idx.append(model.nframes - 1)
            radii.append(r)
    return model, tuple(idx), radii


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
