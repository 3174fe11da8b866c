"""URDF -> RobotModel loader (port of `jiminy_tpu.models.urdf`, host-side
numpy float64).

Parses the kinematic tree, optionally roots it on a free-flyer joint, folds
fixed (and locked) joints away by merging their link inertias into the
supporting movable link, and records an operational frame for every link and
fixed joint. `parse_collision_geometries` reads the links' `<collision>`
geometries, a mesh as its vertex cloud (`load_mesh_vertices`, OBJ or STL);
`parse_visual_geometries` reads the `<visual>` ones for the collision-mesh
fallback, and `oriented_bounding_box` turns a cloud into its box's corners.
The visual geometry of the viewer is not ported yet (ROADMAP.md queue 1
item 14).
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


def load_mesh_vertices(path: str, scale=None) -> np.ndarray:
    """The vertex cloud of an OBJ or STL mesh file, (N, 3) float64: OBJ `v`
    records, STL binary (84-byte header and 50-byte triangles, vertices
    deduplicated) or ASCII `vertex` lines. `scale` is an optional scalar or
    (3,) factor (URDF `<mesh scale=...>`)."""
    ext = os.path.splitext(path)[1].lower()
    verts: list = []
    if ext == ".obj":
        with open(path, "r", errors="ignore") as f:
            for line in f:
                if line.startswith("v "):
                    parts = line.split()
                    verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
        out = np.asarray(verts, dtype=np.float64)
    elif ext == ".stl":
        with open(path, "rb") as f:
            data = f.read()
        if data[:5] == b"solid" and b"facet" in data[:500]:
            for line in data.decode(errors="ignore").splitlines():
                parts = line.split()
                if parts[:1] == ["vertex"]:
                    verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            out = np.asarray(verts, dtype=np.float64)
        else:
            (ntri,) = np.frombuffer(data[80:84], dtype="<u4")
            tri = np.frombuffer(data[84 : 84 + 50 * int(ntri)], dtype=np.uint8).reshape(
                int(ntri), 50)
            # each record: normal (3 floats), 3 vertices (9 floats), 2 bytes
            floats = tri[:, :48].copy().view("<f4").reshape(int(ntri), 4, 3)
            out = floats[:, 1:, :].reshape(-1, 3).astype(np.float64)
        if out.size:
            out = np.unique(out, axis=0)
    else:
        raise ValueError(f"unsupported mesh format '{ext}' ({path})")
    if out.size == 0:
        raise ValueError(f"no vertices found in mesh {path}")
    if scale is not None:
        out = out * np.asarray(scale, dtype=np.float64)
    return out


def oriented_bounding_box(points: np.ndarray) -> np.ndarray:
    """The 8 corners of a near-minimum-volume oriented bounding box of a
    point cloud: over the orientations with a face flush to a facet of the
    convex hull, the in-plane rotation by the minimum-area rectangle of the
    projected hull (rotating calipers). (8, 3), ordered by the sign pattern
    (-/-/-, -/-/+, ..., +/+/+) of the box axes, sorted so that the shortest
    extent is the last axis."""
    from scipy.spatial import ConvexHull

    pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    hull = ConvexHull(pts)
    hp = pts[np.unique(hull.vertices)]

    def min_area_rect(xy: np.ndarray) -> np.ndarray:
        poly = xy[ConvexHull(xy).vertices]
        edges = np.roll(poly, -1, axis=0) - poly
        angles = np.unique(np.mod(np.arctan2(edges[:, 1], edges[:, 0]), np.pi / 2))
        best_area, best = np.inf, np.eye(2)
        for a in angles:
            c, s = np.cos(a), np.sin(a)
            r = np.array([[c, s], [-s, c]])
            proj = poly @ r.T
            ext = proj.max(axis=0) - proj.min(axis=0)
            area = float(ext[0] * ext[1])
            if area < best_area:
                best_area, best = area, r
        return best

    best_vol, best_rot = np.inf, np.eye(3)
    normals = np.unique(np.round(hull.equations[:, :3], 9), axis=0)
    for n in normals:
        n = n / np.linalg.norm(n)
        ref = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        u = np.cross(n, ref)
        u /= np.linalg.norm(u)
        w = np.cross(n, u)
        r2 = min_area_rect(hp @ np.stack([u, w], axis=1))
        axes = np.vstack([r2 @ np.vstack([u, w]), n[None]])  # rows: the box axes
        proj = hp @ axes.T
        vol = float(np.prod(proj.max(axis=0) - proj.min(axis=0)))
        if vol < best_vol:
            best_vol, best_rot = vol, axes
    proj = hp @ best_rot.T
    lo, hi = proj.min(axis=0), proj.max(axis=0)
    order = np.argsort(-(hi - lo))
    rot, lo, hi = best_rot[order], lo[order], hi[order]
    corners = np.array([
        [hi[0] if i & 4 else lo[0], hi[1] if i & 2 else lo[1], hi[2] if i & 1 else lo[2]]
        for i in range(8)
    ])
    return corners @ rot


def _resolve_mesh_path(filename: str, urdf_dir: str, mesh_dirs=()) -> str:
    """The file of a URDF mesh reference (`package://...` or a path)."""
    cands = []
    if filename.startswith("package://"):
        rel = filename[len("package://") :]
        for base in (*mesh_dirs, urdf_dir):
            cands.append(os.path.join(base, rel))
            cands.append(os.path.join(base, *rel.split("/")[1:]))  # without the package
    elif os.path.isabs(filename):
        cands.append(filename)
    else:
        for base in (urdf_dir, *mesh_dirs):
            cands.append(os.path.join(base, filename))
    for c in cands:
        if os.path.exists(c):
            return c
    raise FileNotFoundError(f"mesh '{filename}' not found (tried {cands})")


def parse_visual_geometries(path_or_str: str) -> dict[str, list[dict]]:
    """Per-link `<visual>` geometries: `{link: [spec, ...]}`, each spec its
    `origin` (rot, pos), its `tag` and the element's attributes as read
    (a mesh's `filename` and `scale` unresolved). The collision-mesh
    fallback of a link without collision geometry reads them."""
    root = ET.parse(path_or_str).getroot() if os.path.exists(path_or_str) else ET.fromstring(
        path_or_str)
    out: dict[str, list[dict]] = {}
    for link in root.findall("link"):
        specs = []
        for vis in link.findall("visual"):
            geom = vis.find("geometry")
            if geom is None or len(geom) == 0:
                continue
            g = geom[0]
            spec: dict = {"frame_name": link.get("name"),
                          "origin": _parse_origin(vis.find("origin")), "tag": g.tag}
            spec.update(g.attrib)
            specs.append(spec)
        if specs:
            out[link.get("name")] = specs
    return out


def parse_collision_geometries(path_or_str: str, mesh_dirs=(), links=None) -> dict[str, list[dict]]:
    """Per-link ``<collision>`` geometries of a URDF: ``{link: [spec, ...]}``,
    each spec a `Robot.build(collision_bodies=...)` dict with its geometry
    kind, parameters and ``origin`` (rot, pos) in the link frame.

    ``links`` restricts parsing to the named links. Boxes, spheres,
    cylinders and capsules are read as such; a mesh loads its vertex cloud
    (``points``) and keeps its file (``filename``)."""
    if os.path.exists(path_or_str):
        root = ET.parse(path_or_str).getroot()
        urdf_dir = os.path.dirname(os.path.abspath(path_or_str))
    else:
        root = ET.fromstring(path_or_str)
        urdf_dir = os.getcwd()
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
                scale = g.get("scale")
                scale = np.array([float(x) for x in scale.split()]) if scale else None
                path = _resolve_mesh_path(g.get("filename"), urdf_dir, mesh_dirs)
                spec.update(geometry="mesh", points=load_mesh_vertices(path, scale),
                            filename=path)
            else:
                raise ValueError(f"unsupported collision geometry <{g.tag}> on link {lname}")
            specs.append(spec)
        if specs:
            out[lname] = specs
    return out
