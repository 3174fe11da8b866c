"""The port's collision pairs (body-to-body narrowphase, `Robot.build(...,
collision_pairs=...)`) against jiminy_tpu at float64.

Every narrowphase function runs on seeded random segments, points and boxes
(numpy) with face, edge, parallel and degenerate cases at 1e-12; the pair
geometries of each primitive and of a mesh equal jiminy_tpu's, and so do
the pair forces of the fixtures of `tests/test_self_collision.py`, built by
both packages; a pair of bare points warns. Their engine periods are in
`tests/test_torch_collision_pairs_engine.py`.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generic_checks import close_scaled
from jiminy_torch.engine import contact as t_contact
from jiminy_torch.engine import robot as t_robot_mod
from jiminy_torch.engine.config import ContactOptions as TContactOptions
from jiminy_torch.engine.robot import Robot as TRobot
from jiminy_torch.envs import assets as t_assets
from jiminy_torch.models.model import build_model as t_build_model
from jiminy_torch.ops.kinematics import forward_kinematics as t_fk
from jiminy_tpu.engine import Robot as JRobot
from jiminy_tpu.engine import contact as j_contact
from jiminy_tpu.engine import robot as j_robot_mod
from jiminy_tpu.engine.config import ContactOptions as JContactOptions
from jiminy_tpu.envs import assets as j_assets
from jiminy_tpu.models import JointType
from jiminy_tpu.models import build_model as j_build_model
from jiminy_tpu.ops.kinematics import forward_kinematics as j_fk

ATOL = 1e-12
CONTACT = dict(stiffness=2e3, damping=20.0, friction=0.3, transition_eps=0.0)


def t64(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def j64(x):
    return jnp.asarray(np.asarray(x, np.float64))


def close(got, want, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=0.0, err_msg=msg)


def random_rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)


# --------------------------------------------------------------------------- #
# Narrowphase functions
# --------------------------------------------------------------------------- #


def test_closest_segment_points_match_jax():
    rng = np.random.default_rng(0)
    n = 64
    p1, q1, p2, q2 = (rng.normal(size=(n, 3)) for _ in range(4))
    q2[:8] = p2[:8] + 0.7 * (q1[:8] - p1[:8])  # parallel segments
    q1[8:12] = p1[8:12]  # a zero-length first segment
    q2[12:16] = p2[12:16]  # a zero-length second segment
    q1[16:18], q2[16:18] = p1[16:18], p2[16:18]  # two points
    got = t_contact.closest_segment_points(t64(p1), t64(q1), t64(p2), t64(q2))
    want = j_contact.closest_segment_points(j64(p1), j64(q1), j64(p2), j64(q2))
    for g, w in zip(got, want):
        close(g, w)


def _boxes(rng, n):
    rot = random_rotations(rng, n)
    rot[:4] = np.eye(3)  # axis-aligned (the SAT's parallel edge axes)
    pos = rng.normal(size=(n, 3)) * 0.3
    half = rng.uniform(0.05, 0.3, size=3)
    return rot, pos, half


def test_signed_point_box_matches_jax():
    rng = np.random.default_rng(1)
    n = 96
    rot, pos, half = _boxes(rng, n)
    local = rng.normal(size=(n, 3)) * 0.4  # inside and outside
    local[:6] = [[0.5, 0.0, 0.0], [0.0, 0.0, 0.0], [0.01, 0.01, 0.0], [0.0, 0.0, 0.0],
                 [half[0], 0.0, 0.0], [0.0, -half[1], half[2]]]  # face, centre, corner ties
    p = pos + np.einsum("nij,nj->ni", rot, local)
    got = t_contact.signed_point_box(t64(p), t64(rot), t64(pos), t64(half))
    want = j_contact.signed_point_box(j64(p), j64(rot), j64(pos), j64(half))
    for g, w, name in zip(got, want, ("dist", "normal", "surface")):
        close(g, w, msg=name)
    assert bool((got[0] < 0).any()) and bool((got[0] > 0).any())


def test_closest_point_segment_box_matches_jax():
    rng = np.random.default_rng(2)
    n = 48
    rot, pos, half = _boxes(rng, n)
    p0 = pos + rng.normal(size=(n, 3)) * 0.5
    p1 = p0 + rng.normal(size=(n, 3)) * 0.5
    p1[:4] = p0[:4]  # a point
    got = t_contact.closest_point_segment_box(t64(p0), t64(p1), t64(rot), t64(pos), t64(half))
    want = j_contact.closest_point_segment_box(j64(p0), j64(p1), j64(rot), j64(pos), j64(half))
    close(got, want)


def test_box_box_sat_matches_jax():
    """Random boxes, face-face, edge-edge and parallel (axis-aligned) pairs:
    the gap, the normal (the first axis on a tie, as JAX's arg-max) and the
    contact point. The point's support corners take the sign of the normal
    against each box axis: where the normal is a box's face normal, its
    projection on that box's other axes is rounding noise (~1e-17) whose
    sign either program may round either way (a jump of one half extent):
    the point is held wherever the two programs' signs agree, and where they
    do not, the projection must be such noise."""
    rng = np.random.default_rng(3)
    n = 96
    rot_a, pos_a, half_a = _boxes(rng, n)
    rot_b, pos_b, half_b = _boxes(rng, n)
    c45, s45 = np.cos(np.pi / 4), np.sin(np.pi / 4)
    rot_b[4] = [[c45, -s45, 0], [s45, c45, 0], [0, 0, 1.0]]  # edge on a face
    rot_a[4], pos_a[4], pos_b[4] = np.eye(3), 0.0, [0.3, 0.0, 0.0]
    rot_b[5] = [[1.0, 0, 0], [0, c45, -s45], [0, s45, c45]]  # the diagonal cross axes
    rot_a[5], pos_a[5], pos_b[5] = np.eye(3), 0.0, [0.0, 0.15, 0.15]
    pos_b[6], pos_a[6] = pos_a[6], pos_a[6]  # coincident centres: ties everywhere
    rot_b[6] = rot_a[6]
    got = t_contact.box_box_sat(t64(rot_a), t64(pos_a), t64(half_a), t64(rot_b), t64(pos_b),
                                t64(half_b))
    want = j_contact.box_box_sat(j64(rot_a), j64(pos_a), j64(half_a), j64(rot_b), j64(pos_b),
                                 j64(half_b))
    for g, w, name in zip(got[:2], want[:2], ("gap", "normal")):
        close(g, w, msg=name)
    def projections(n):
        return np.concatenate([np.einsum("ni,nik->nk", n, rot_a),
                               np.einsum("ni,nik->nk", n, rot_b)], axis=1)

    proj_t, proj_j = projections(got[1].numpy()), projections(np.asarray(want[1]))
    agree = (np.sign(proj_t) == np.sign(proj_j)).all(axis=1)
    assert agree.sum() >= n - 2
    assert np.abs(proj_j[np.sign(proj_t) != np.sign(proj_j)]).max(initial=0.0) < 1e-12
    close(got[2][agree], np.asarray(want[2])[agree], msg="point")
    assert bool((got[0] < 0).any()) and bool((got[0] > 0).any())


# --------------------------------------------------------------------------- #
# The fixtures of tests/test_self_collision.py, built by both packages
# --------------------------------------------------------------------------- #


def _free(name):
    return {"name": name, "type": JointType.FREE, "parent": -1, "mass": 1.0,
            "com": np.zeros(3), "inertia": np.eye(3) * 1e-2}


def _child(name, jtype, axis, com=(0.0, 0.0, 0.0)):
    return {"name": name, "type": jtype, "parent": 0, "axis": np.asarray(axis, float),
            "placement": (np.eye(3), np.zeros(3)), "mass": 1.0, "com": np.asarray(com, float),
            "inertia": np.eye(3) * 1e-2}


def _frame(name, parent, pos):
    return {"name": name, "parent": parent, "placement": (np.eye(3), np.asarray(pos, float))}


MESH_POINTS = np.random.default_rng(0).normal(size=(40, 3)) * [0.1, 0.05, 0.02]

FIXTURES = {
    # a sphere on the base off the arm's axis, one on the arm's tip
    "dumbbell": ([_free("root"), _child("arm", JointType.REVOLUTE, (0, 0, 1), (0.15, 0, 0))],
                 [_frame("baseF", 0, (0, 0.1, 0)), _frame("tipF", 1, (0.15, 0, 0))],
                 [{"frame_name": "baseF", "geometry": "sphere", "radius": 0.1},
                  {"frame_name": "tipF", "geometry": "sphere", "radius": 0.1}],
                 ("baseF", "tipF")),
    # crossing capsules touching mid-segment
    "cross": ([_free("root"), _child("arm", JointType.REVOLUTE, (0, 0, 1))],
              [_frame("baseF", 0, (0, 0, 0)), _frame("tipF", 1, (0, 0, 0.08))],
              [{"frame_name": "baseF", "geometry": "capsule", "radius": 0.05, "length": 0.3,
                "axis": (0.0, 1.0, 0.0)},
               {"frame_name": "tipF", "geometry": "capsule", "radius": 0.05, "length": 0.3,
                "axis": (1.0, 0.0, 0.0)}],
              ("baseF", "tipF")),
    # coincident boxes (15-axis SAT)
    "boxes": ([_free("root"), _child("arm", JointType.PRISMATIC, (1, 0, 0))],
              [_frame("baseF", 0, (0, 0, 0)), _frame("tipF", 1, (0, 0, 0))],
              [{"frame_name": "baseF", "geometry": "box", "size": (0.2, 0.2, 0.2)},
               {"frame_name": "tipF", "geometry": "box", "size": (0.2, 0.2, 0.2)}],
              ("baseF", "tipF")),
    # a capsule above a box
    "capbox": ([_free("root"), _child("arm", JointType.PRISMATIC, (0, 0, 1))],
               [_frame("boxF", 0, (0, 0, 0)), _frame("capF", 1, (0, 0, 0.3))],
               [{"frame_name": "boxF", "geometry": "box", "size": (0.4, 0.4, 0.4)},
                {"frame_name": "capF", "geometry": "capsule", "radius": 0.05, "length": 0.2,
                 "axis": (1.0, 0.0, 0.0)}],
               ("boxF", "capF")),
    # a mesh's oriented bounding box against a sphere, and a cylinder
    "mesh": ([_free("root"), _child("arm", JointType.PRISMATIC, (1, 0, 0))],
             [_frame("mF", 0, (0, 0, 0)), _frame("sF", 1, (0.15, 0, 0)),
              _frame("cF", 1, (0.0, 0.1, 0.0))],
             [{"frame_name": "mF", "geometry": "mesh", "points": MESH_POINTS},
              {"frame_name": "sF", "geometry": "sphere", "radius": 0.05},
              {"frame_name": "cF", "geometry": "cylinder", "radius": 0.03, "length": 0.1,
               "origin": (np.eye(3), np.array([0.0, 0.0, 0.02]))}],
             ("mF", "sF"), ("cF", "mF")),
}


def build_pair(name, jtype_of=None, **kw):
    """(port robot, jiminy_tpu robot) of a fixture."""
    joints, frames, bodies, *pairs = FIXTURES[name]
    out = []
    for build_model, robot_cls in ((t_build_model, TRobot), (j_build_model, JRobot)):
        model = build_model(name, joints, frames)
        out.append(robot_cls.build(model, collision_bodies=bodies, collision_pairs=pairs, **kw))
    return tuple(out)


def test_pair_geometries_match_jax():
    """Sphere, capsule, cylinder, box and mesh specs (and bare contact
    frames) resolve to jiminy_tpu's tagged geometries; an Atlas foot's
    URDF boxes too."""
    for name in FIXTURES:
        tr, jr = build_pair(name)
        assert tr.collision_pairs_geom == jr.collision_pairs_geom, name
        bodies = FIXTURES[name][2]
        got = t_robot_mod._pair_geometries(tr.model, bodies, tr.contact_frame_indices)
        want = j_robot_mod._pair_geometries(jr.model, bodies, jr.contact_frame_indices)
        assert got == want, name
    kinds = {g[1] for pair in build_pair("mesh")[0].collision_pairs_geom for g in pair}
    assert kinds == {"box", "capsule"}
    urdf = t_assets.urdf_path("atlas")
    pairs = [("l_foot", "r_foot")]
    tr = TRobot.build(urdf, has_freeflyer=True, collision_bodies=["l_foot", "r_foot"],
                      collision_pairs=pairs)
    jr = JRobot.build(j_assets.urdf_path("atlas"), has_freeflyer=True,
                      collision_bodies=["l_foot", "r_foot"], collision_pairs=pairs)
    assert tr.collision_pairs_geom == jr.collision_pairs_geom
    assert len(tr.collision_pairs_geom) == 4  # two boxes a foot


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_pair_forces_match_jax(name):
    """`compute_pair_forces` and `pair_narrowphase_force` at seeded states
    around the fixture's neutral pose: wrenches, forces, depths, points."""
    tr, jr = build_pair(name)
    model = tr.model
    rng = np.random.default_rng(7)
    q = np.tile(np.asarray(model.neutral()), (16, 1))
    q[:, -1] += rng.uniform(-0.15, 0.15, size=16)
    q[:, :3] += rng.normal(size=(16, 3)) * 0.02
    v = rng.normal(size=(16, model.nv))
    opts_t, opts_j = TContactOptions(**CONTACT), JContactOptions(**CONTACT)
    kin_t = t_fk(model, t64(q), t64(v), t64(np.zeros_like(v)))
    kin_j = jax.vmap(lambda q_, v_: j_fk(jr.model, q_, v_, jnp.zeros_like(v_)))(j64(q), j64(v))
    got = t_contact.compute_pair_forces(model, opts_t, kin_t, tr.collision_pairs_geom)
    want = jax.vmap(lambda k: j_contact.compute_pair_forces(jr.model, opts_j, k,
                                                           jr.collision_pairs_geom))(kin_j)
    for g, w, what in zip(got, want, ("fext", "f_world", "depth")):
        close_scaled(g, w, tol=ATOL, msg=f"{name} {what}")
    assert bool((got[2] < 0).any()), name  # some envs penetrate
    ga, gb = tr.collision_pairs_geom[-1]  # the pair's point, force and depth
    g = t_contact.pair_narrowphase_force(opts_t, kin_t, ga, kin_t, gb)
    w = jax.vmap(lambda k: j_contact.pair_narrowphase_force(opts_j, k, ga, k, gb))(kin_j)
    for x, y in zip(g[:3], w[:3]):
        close_scaled(x, y, tol=ATOL, msg=name)


def test_zero_radius_pair_warns():
    """A pair of bare contact frames on both sides can never push: both
    packages warn at build time."""
    joints = [_free("root")]
    frames = [_frame("fA", 0, (0, 0, 0)), _frame("fB", 0, (0.1, 0, 0))]
    for build_model, robot_cls in ((t_build_model, TRobot), (j_build_model, JRobot)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            r = robot_cls.build(build_model("frames", joints, frames), contact_frames=["fA", "fB"],
                                collision_pairs=[("fA", "fB")])
        assert any("zero-radius" in str(w.message) for w in caught), robot_cls
        assert len(r.collision_pairs_geom) == 1
    with pytest.raises(ValueError, match="no contact frame or collision body"):
        TRobot.build(t_build_model("frames", joints, frames), collision_pairs=[("fA", "fB")])
