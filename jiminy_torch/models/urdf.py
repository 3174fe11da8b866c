"""URDF -> RobotModel loader (port of `jiminy_tpu.models.urdf`, host-side
numpy float64).

Parses the kinematic tree, optionally roots it on a free-flyer joint, folds
fixed (and locked) joints away by merging their link inertias into the
supporting movable link, and records an operational frame for every link and
fixed joint. `parse_collision_geometries` reads the links' primitive
`<collision>` geometries; meshes and visual geometry are not ported yet
(ROADMAP.md queue 1 item 10, collision meshes; item 14, viewer).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Optional, Sequence

import numpy as np

from jiminy_torch.models import joints as jt
from jiminy_torch.models.model import RobotModel, build_model


def _parse_origin(elem: Optional[ET.Element]) -> tuple[np.ndarray, np.ndarray]:
    if elem is None:
        return np.eye(3), np.zeros(3)
    xyz = np.array([float(x) for x in elem.get("xyz", "0 0 0").split()])
    rpy = np.array([float(x) for x in elem.get("rpy", "0 0 0").split()])
    return _rpy_mat(rpy), xyz


def _axis_angle_mat(axis: np.ndarray, theta: float) -> np.ndarray:
    k = np.asarray(axis, dtype=float)
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1.0 - np.cos(theta)) * (kx @ kx)


def _rpy_mat(rpy: np.ndarray) -> np.ndarray:
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


class _LinkInertia:
    """Mass, CoM and rotational inertia about the CoM, in a given frame."""

    def __init__(self, mass=0.0, com=None, inertia=None):
        self.mass = float(mass)
        self.com = np.zeros(3) if com is None else np.asarray(com, dtype=float)
        self.inertia = np.zeros((3, 3)) if inertia is None else np.asarray(inertia, dtype=float)

    @staticmethod
    def from_urdf(link: ET.Element) -> "_LinkInertia":
        inertial = link.find("inertial")
        if inertial is None:
            return _LinkInertia()
        rot, pos = _parse_origin(inertial.find("origin"))
        mass_el = inertial.find("mass")
        mass = float(mass_el.get("value")) if mass_el is not None else 0.0
        in_el = inertial.find("inertia")
        if in_el is not None:
            ixx, iyy, izz = (float(in_el.get(k, "0")) for k in ("ixx", "iyy", "izz"))
            ixy, ixz, iyz = (float(in_el.get(k, "0")) for k in ("ixy", "ixz", "iyz"))
            i_c = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
        else:
            i_c = np.zeros((3, 3))
        return _LinkInertia(mass, pos, rot @ i_c @ rot.T)

    def transformed(self, rot: np.ndarray, pos: np.ndarray) -> "_LinkInertia":
        return _LinkInertia(self.mass, rot @ self.com + pos, rot @ self.inertia @ rot.T)

    def merged(self, other: "_LinkInertia") -> "_LinkInertia":
        m = self.mass + other.mass
        if m <= 0.0:
            return _LinkInertia(m, np.zeros(3), self.inertia + other.inertia)
        com = (self.mass * self.com + other.mass * other.com) / m

        def shift(li: "_LinkInertia") -> np.ndarray:
            d = li.com - com
            return li.inertia + li.mass * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

        return _LinkInertia(m, com, shift(self) + shift(other))


_JOINT_TYPE_MAP = {
    "revolute": jt.JointType.REVOLUTE,
    "continuous": jt.JointType.REVOLUTE_UNBOUNDED,
    "prismatic": jt.JointType.PRISMATIC,
    "floating": jt.JointType.FREE,
}


def _axis_of(joint: ET.Element) -> np.ndarray:
    axis_el = joint.find("axis")
    if axis_el is None:
        return np.array([1.0, 0.0, 0.0])
    return np.array([float(x) for x in axis_el.get("xyz").split()])


def build_model_from_urdf(
    path_or_str: str,
    has_freeflyer: bool = False,
    root_joint_name: str = "root_joint",
    lock_joints: Sequence[str] = (),
) -> RobotModel:
    """Parse a URDF file (or literal XML string) into a RobotModel.

    ``lock_joints`` folds the named movable joints away: a sequence of names
    (locked at 0) or a ``{name: angle}`` mapping (locked at that position)."""
    if os.path.exists(path_or_str):
        root = ET.parse(path_or_str).getroot()
    else:
        root = ET.fromstring(path_or_str)
    name = root.get("name", "robot")

    links = {link.get("name"): link for link in root.findall("link")}
    joints_by_child: dict[str, ET.Element] = {}
    children_of: dict[str, list[ET.Element]] = {}
    for joint in root.findall("joint"):
        child = joint.find("child").get("link")
        parent = joint.find("parent").get("link")
        joints_by_child[child] = joint
        children_of.setdefault(parent, []).append(joint)

    root_links = [ln for ln in links if ln not in joints_by_child]
    if len(root_links) != 1:
        raise ValueError(f"expected one root link, got {root_links}")

    lock_angles = dict(lock_joints) if isinstance(lock_joints, dict) else {}
    lock_set = set(lock_joints)
    joint_specs: list[dict] = []
    frame_specs: list[dict] = []
    inertias: dict[int, _LinkInertia] = {}

    def visit(link_name: str, parent_joint: int, rot: np.ndarray, pos: np.ndarray):
        """Attach `link_name` at (rot, pos) in joint `parent_joint`'s moving
        frame, then recurse into its child joints."""
        li = _LinkInertia.from_urdf(links[link_name]).transformed(rot, pos)
        if parent_joint >= 0:
            inertias[parent_joint] = inertias.get(parent_joint, _LinkInertia()).merged(li)
        frame_specs.append({"name": link_name, "parent": parent_joint, "placement": (rot, pos)})

        for joint in children_of.get(link_name, []):
            jname = joint.get("name")
            jtype_str = joint.get("type")
            j_rot, j_pos = _parse_origin(joint.find("origin"))
            a_rot, a_pos = rot @ j_rot, rot @ j_pos + pos
            child_link = joint.find("child").get("link")
            if jtype_str == "fixed" or jname in lock_set:
                if jname in lock_set:
                    theta = lock_angles.get(jname, 0.0)
                    lock_set.discard(jname)
                    if theta != 0.0:
                        axis = _axis_of(joint)
                        axis = axis / max(np.linalg.norm(axis), 1e-12)
                        if jtype_str == "prismatic":
                            a_pos = a_pos + a_rot @ (axis * theta)
                        else:
                            a_rot = a_rot @ _axis_angle_mat(axis, theta)
                frame_specs.append(
                    {"name": jname, "parent": parent_joint, "placement": (a_rot, a_pos)}
                )
                visit(child_link, parent_joint, a_rot, a_pos)
                continue
            if jtype_str not in _JOINT_TYPE_MAP:
                raise ValueError(f"unsupported joint type '{jtype_str}' ({jname})")
            t = _JOINT_TYPE_MAP[jtype_str]
            axis = _axis_of(joint)
            nrm = np.linalg.norm(axis)
            axis = axis / nrm if nrm > 0 else axis
            dyn_el = joint.find("dynamics")
            damping = float(dyn_el.get("damping", "0")) if dyn_el is not None else 0.0
            limit_el = joint.find("limit")
            lo = hi = None
            eff = vel = np.inf
            if limit_el is not None:
                if limit_el.get("lower") is not None and t in (
                    jt.JointType.REVOLUTE,
                    jt.JointType.PRISMATIC,
                ):
                    lo = np.array([float(limit_el.get("lower", "0"))])
                    hi = np.array([float(limit_el.get("upper", "0"))])
                if limit_el.get("effort") is not None:
                    eff = float(limit_el.get("effort"))
                if limit_el.get("velocity") is not None:
                    vel = float(limit_el.get("velocity"))
            idx = len(joint_specs)
            joint_specs.append(
                {
                    "name": jname,
                    "type": t,
                    "parent": parent_joint,
                    "placement": (a_rot, a_pos),
                    "axis": axis,
                    "damping": damping,
                    "position_limit": (lo, hi),
                    "velocity_limit": vel,
                    "effort_limit": eff,
                }
            )
            visit(child_link, idx, np.eye(3), np.zeros(3))

    if has_freeflyer:
        joint_specs.append(
            {
                "name": root_joint_name,
                "type": jt.JointType.FREE,
                "parent": -1,
                "placement": (np.eye(3), np.zeros(3)),
                "axis": np.array([0.0, 0.0, 1.0]),
                "position_limit": (None, None),
            }
        )
        visit(root_links[0], 0, np.eye(3), np.zeros(3))
    else:
        visit(root_links[0], -1, np.eye(3), np.zeros(3))

    if lock_set:
        raise ValueError(f"lock_joints not found in URDF: {sorted(lock_set)}")
    for i, spec in enumerate(joint_specs):
        li = inertias.get(i, _LinkInertia())
        spec["mass"], spec["com"], spec["inertia"] = li.mass, li.com, li.inertia
        lo, hi = spec.pop("position_limit", (None, None))
        if lo is not None:
            spec["position_limit"] = (lo, hi)

    return build_model(name, joint_specs, frame_specs)


def parse_collision_geometries(path_or_str: str, links=None) -> dict[str, list[dict]]:
    """Per-link ``<collision>`` primitives of a URDF: ``{link: [spec, ...]}``,
    each spec a `Robot.build(collision_bodies=...)` dict with its geometry
    kind, parameters and ``origin`` (rot, pos) in the link frame.

    ``links`` restricts parsing to the named links. Boxes, spheres,
    cylinders and capsules are read; a mesh raises (its vertex loading is
    not ported yet)."""
    if os.path.exists(path_or_str):
        root = ET.parse(path_or_str).getroot()
    else:
        root = ET.fromstring(path_or_str)
    out: dict[str, list[dict]] = {}
    for link in root.findall("link"):
        lname = link.get("name")
        if links is not None and lname not in links:
            continue
        specs = []
        for col in link.findall("collision"):
            geom = col.find("geometry")
            if geom is None or len(geom) == 0:
                continue
            g = geom[0]
            spec: dict = {"frame_name": lname, "origin": _parse_origin(col.find("origin"))}
            if g.tag == "box":
                spec.update(geometry="box", size=tuple(float(x) for x in g.get("size").split()))
            elif g.tag == "sphere":
                spec.update(geometry="sphere", radius=float(g.get("radius")))
            elif g.tag in ("cylinder", "capsule"):
                spec.update(geometry=g.tag, radius=float(g.get("radius")),
                            length=float(g.get("length")))
            elif g.tag == "mesh":
                raise NotImplementedError(
                    f"collision mesh on link {lname}: mesh loading is not ported yet "
                    "(ROADMAP.md queue 1 item 10)"
                )
            else:
                raise ValueError(f"unsupported collision geometry <{g.tag}> on link {lname}")
            specs.append(spec)
        if specs:
            out[lname] = specs
    return out
