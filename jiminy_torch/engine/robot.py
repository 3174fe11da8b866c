"""Robot = model + motors + sensors + contact frames + flexibility (port of
`jiminy_tpu.engine.robot`).

This slice assembles motors (armature folded onto the model diagonal),
encoder, effort, IMU, contact and force sensors, point contact frames,
collision bodies expanded into contact points (a sphere one radius-r point,
a capsule two, boxes, cylinder rims and point clouds radius-0 points), loop
closures (distance constraints between two frames, `loop_pairs`), rolling
constraints (`rolling_specs`: a sphere or a wheel on a frame), and the
extended model of the reference (`model.cc`, `robot.cc`): spherical
flexibility joints inserted before the named joints, and a passive revolute
backlash joint after each motor joint that declares play. The
`theoretical_model` is the model before that surgery; the state maps carry
positions and velocities between the two. Collision pairs are refused with
the ROADMAP.md item that will port them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from jiminy_torch.engine.hardware import (
    ContactSensorGroup,
    EffortSensorGroup,
    EncoderSensorGroup,
    ForceSensorGroup,
    ImuSensorGroup,
    MotorBank,
    SensorSuite,
    _Placed,
    build_motor_bank,
)
from jiminy_torch.models import joints as jt
from jiminy_torch.models.model import RobotModel, build_model
from jiminy_torch.models.urdf import build_model_from_urdf, parse_collision_geometries


@dataclasses.dataclass(eq=False)
class FlexibilityConfig(_Placed):
    """Spherical spring-damper flexibility joints (reference
    `model.cc:1087-1164`, internal dynamics `engine.cc:3340-3392`): their
    joint indices in the extended model and per joint (nflex, 3) stiffness,
    damping and inertia."""

    joint_indices: tuple
    stiffness: np.ndarray
    damping: np.ndarray
    inertia: np.ndarray


@dataclasses.dataclass(eq=False)
class Robot:
    name: str
    model: RobotModel  # the extended model (flexibility and backlash joints in)
    # The model before the extension (None: the same as `model`)
    theoretical_model: Optional[RobotModel] = None
    motors: Optional[MotorBank] = None
    sensors: SensorSuite = dataclasses.field(default_factory=SensorSuite)
    contact_frame_indices: tuple = ()
    contact_radii: tuple = ()
    flexibility: Optional[FlexibilityConfig] = None
    # Closed kinematic loops: ((frame_a, frame_b), ...) distance constraints
    loop_pairs: tuple = ()
    # Passive backlash joints in series after the motor joints with play
    backlash_joint_indices: tuple = ()
    # Rolling constraints: ((frame_name, radius, axis or None), ...); None is
    # a sphere, an axis (in the frame) a wheel
    rolling_specs: tuple = ()

    def __post_init__(self):
        if self.theoretical_model is None:
            self.theoretical_model = self.model

    @property
    def has_flexibility(self) -> bool:
        return self.flexibility is not None and bool(self.flexibility.joint_indices)

    # ------------------------------------------------------------------ #
    # Theoretical <-> extended state maps (reference `model.h:366-373`).
    # The surgery keeps the joint names, so the maps match names.
    # ------------------------------------------------------------------ #
    def _state_index_maps(self):
        """(ext q <- th, ext v <- th, th q <- ext, th v <- ext) index arrays;
        -1 marks the extended-only slots (flexibility and backlash joints)."""
        maps = self.__dict__.get("_maps")
        if maps is None:
            th, ext = self.theoretical_model, self.model
            q_map = -np.ones(ext.nq, np.int64)
            v_map = -np.ones(ext.nv, np.int64)
            th_q = np.zeros(th.nq, np.int64)
            th_v = np.zeros(th.nv, np.int64)
            for j, nm in enumerate(ext.joint_names):
                if nm not in th.joint_names:
                    continue
                i = th.joint_names.index(nm)
                for k in range(ext.nq_of(j)):
                    q_map[ext.idx_q[j] + k] = th.idx_q[i] + k
                    th_q[th.idx_q[i] + k] = ext.idx_q[j] + k
                for k in range(ext.nv_of(j)):
                    v_map[ext.idx_v[j] + k] = th.idx_v[i] + k
                    th_v[th.idx_v[i] + k] = ext.idx_v[j] + k
            maps = self.__dict__["_maps"] = (q_map, v_map, th_q, th_v)
        return maps

    @staticmethod
    def _take(x, index) -> torch.Tensor:
        x = torch.as_tensor(x)
        if not x.is_floating_point():
            x = x.to(torch.float64)
        return torch.index_select(x, -1, torch.as_tensor(index, device=x.device))

    def extended_position_from_theoretical(self, q) -> torch.Tensor:
        """Theoretical q -> extended q, the flexibility quaternions and
        backlash angles at neutral; batch-transparent."""
        q_map = self._state_index_maps()[0]
        out = self._take(q, np.maximum(q_map, 0))
        keep = torch.as_tensor(q_map >= 0, device=out.device)
        return torch.where(keep, out, torch.as_tensor(self.model.neutral(), dtype=out.dtype,
                                                      device=out.device))

    def extended_velocity_from_theoretical(self, v) -> torch.Tensor:
        """Theoretical v -> extended v, the extended-only dofs at rest."""
        v_map = self._state_index_maps()[1]
        out = self._take(v, np.maximum(v_map, 0))
        return torch.where(torch.as_tensor(v_map >= 0, device=out.device), out, 0.0)

    def theoretical_position_from_extended(self, q) -> torch.Tensor:
        """Extended q -> theoretical q (the extended-only slots dropped)."""
        return self._take(q, self._state_index_maps()[2])

    def theoretical_velocity_from_extended(self, v) -> torch.Tensor:
        """Extended v -> theoretical v."""
        return self._take(v, self._state_index_maps()[3])

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
        """Assemble a robot from a RobotModel or a URDF (path or XML string).
        `flexibility`: [{joint_name (or frame_name), stiffness, damping,
        inertia}] (each a float or 3 floats), a spherical joint inserted
        before each named joint; a motor spec's `backlash` > 0 inserts a
        backlash joint of that play after its joint."""
        if collision_pairs:
            raise NotImplementedError(
                "collision pairs are not ported yet (ROADMAP.md queue 1 item 10)"
            )
        if isinstance(model_or_urdf, RobotModel):
            theoretical = model_or_urdf
        else:
            theoretical = build_model_from_urdf(model_or_urdf, has_freeflyer,
                                                lock_joints=lock_joints)
        model = theoretical
        flex_cfg = None
        if flexibility:
            model, flex_cfg = _add_flexibility_joints(theoretical, flexibility)
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
        name = name or theoretical.name

        bank = build_motor_bank(model, motors) if motors else None
        backlash_idx: tuple = ()
        if bank is not None and np.any(bank.backlash > 0.0):
            model, bank, backlash_idx = _add_backlash_joints(model, bank)
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
            theoretical_model=theoretical,
            motors=bank,
            sensors=suite,
            contact_frame_indices=contact_idx,
            contact_radii=tuple(radii),
            flexibility=flex_cfg,
            loop_pairs=tuple(tuple(p) for p in loop_constraints),
            backlash_joint_indices=backlash_idx,
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

# --------------------------------------------------------------------------- #
# Extended model surgery
# --------------------------------------------------------------------------- #


def _joint_spec(model: RobotModel, i: int, parent: int) -> dict:
    """Joint i of `model` as a `build_model` spec under `parent`."""
    vs, qs = model.v_slice(i), model.q_slice(i)
    return {
        "name": model.joint_names[i],
        "type": jt.JointType(model.joint_types[i]),
        "parent": parent,
        "placement": (np.asarray(model.jplacement_rot[i]), np.asarray(model.jplacement_pos[i])),
        "axis": np.asarray(model.joint_axes[i]),
        "mass": float(model.mass[i]),
        "com": np.asarray(model.com[i]),
        "inertia": np.asarray(model.inertia[i]),
        "armature": np.asarray(model.armature[vs]),
        "damping": np.asarray(model.damping[vs]),
        "position_limit": (np.asarray(model.position_limit_lower[qs]),
                           np.asarray(model.position_limit_upper[qs])),
        "velocity_limit": np.asarray(model.velocity_limit[vs]),
        "effort_limit": np.asarray(model.effort_limit[vs]),
    }


def _rebuild(model: RobotModel, specs: list, index_map: dict) -> RobotModel:
    """`model` rebuilt from joint `specs`, its frames re-parented through
    `index_map` (old joint index -> new)."""
    frame_specs = [
        {"name": model.frame_names[i], "parent": index_map[model.frame_parents[i]],
         "placement": (np.asarray(model.fplacement_rot[i]), np.asarray(model.fplacement_pos[i]))}
        for i in range(model.nframes)
    ]
    return build_model(model.name, specs, frame_specs)


def _add_flexibility_joints(model: RobotModel, flex_specs) -> tuple:
    """A spherical joint inserted before each named joint (the deformation
    before the joint; reference `Model::addFlexibilityJointsToExtendedModel`,
    `model.cc:1087-1164`): it takes the named joint's parent and placement,
    carries the point inertia diag(inertia) and no mass, and the named joint
    hangs from it at the identity. Returns (model, FlexibilityConfig)."""
    specs: list = []
    index_map = {-1: -1}
    entries = {s.get("joint_name") or s["frame_name"]: s for s in flex_specs}
    positions, stiff, damp, inert = [], [], [], []

    def triple(fs, key):
        return np.broadcast_to(np.asarray(fs.get(key, 0.0), float), (3,))

    for i in range(model.njoints):
        spec = _joint_spec(model, i, index_map[model.parents[i]])
        fs = entries.get(model.joint_names[i])
        if fs is not None:
            positions.append(len(specs))
            stiff.append(triple(fs, "stiffness"))
            damp.append(triple(fs, "damping"))
            inert.append(triple(fs, "inertia"))
            specs.append({
                "name": model.joint_names[i] + "_flexibility",
                "type": jt.JointType.SPHERICAL,
                "parent": spec["parent"],
                "placement": spec["placement"],
                "axis": np.array([0.0, 0.0, 1.0]),
                "mass": 0.0,
                "com": np.zeros(3),
                "inertia": np.diag(triple(fs, "inertia")),
            })
            spec["parent"] = len(specs) - 1
            spec["placement"] = (np.eye(3), np.zeros(3))
        index_map[i] = len(specs)
        specs.append(spec)
    cfg = FlexibilityConfig(joint_indices=tuple(positions), stiffness=np.array(stiff),
                            damping=np.array(damp), inertia=np.array(inert))
    return _rebuild(model, specs, index_map), cfg


def _add_backlash_joints(model: RobotModel, bank: MotorBank) -> tuple:
    """A passive revolute joint (the motor joint's axis, limits +-backlash/2)
    inserted after each motor joint that declares play (reference
    `Robot::initializeExtendedModel`, `robot.cc:582-630`): the link's body
    moves to it, the motor joint keeps the transmission and 1e-6 inertia,
    and the joint's children hang from the backlash joint. Returns (model,
    the motor bank remapped onto it, the backlash joints' indices)."""
    backlash_of = {j: float(bank.backlash[k]) for k, j in enumerate(bank.joint_indices)
                   if float(bank.backlash[k]) > 0.0}
    specs: list = []
    index_map = {-1: -1}
    positions = []
    for i in range(model.njoints):
        spec = _joint_spec(model, i, index_map[model.parents[i]])
        index_map[i] = len(specs)
        specs.append(spec)
        if i in backlash_of:
            play = backlash_of[i]
            specs.append({
                "name": model.joint_names[i] + "_backlash",
                "type": jt.JointType.REVOLUTE,
                "parent": index_map[i],
                "placement": (np.eye(3), np.zeros(3)),
                "axis": spec["axis"],
                "mass": spec["mass"],
                "com": spec["com"],
                "inertia": spec["inertia"],
                "position_limit": (np.array([-play / 2.0]), np.array([play / 2.0])),
            })
            spec.update(mass=0.0, com=np.zeros(3), inertia=np.eye(3) * 1e-6)
            positions.append(len(specs) - 1)
            index_map[i] = len(specs) - 1
    new_model = _rebuild(model, specs, index_map)
    joints = [new_model.joint_index(model.joint_names[j]) for j in bank.joint_indices]
    new_bank = dataclasses.replace(
        bank, joint_indices=tuple(joints), v_indices=tuple(new_model.idx_v[j] for j in joints),
        q_indices=tuple(new_model.idx_q[j] for j in joints))
    return new_model, new_bank, tuple(positions)


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

    con_specs = sensor_specs.get("contact", ())
    if con_specs:
        names = [s.get("name", s["frame_name"]) for s in con_specs]
        slots = tuple(contact_idx.index(model.frame_index(s["frame_name"])) for s in con_specs)
        noise, bias, delay, jitter = _opt_arrays(len(names), 3, con_specs)
        suite["contact"] = ContactSensorGroup(
            names=tuple(names),
            contact_slots=slots,
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
