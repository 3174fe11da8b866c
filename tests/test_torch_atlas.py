"""The port's Atlas humanoid (`atlas-reduced-pid`, `atlas-pid`) against
jiminy_tpu on the CPU at float64: collision geometry, robot assembly, PD
gains, the plain component core, and the golden trajectory
tests/goldens/atlas-reduced-pid.csv (zero actions, one env).

Tolerances: model, robot, motor and gain arrays come from the same host
float64 code, so they must be equal (atol 0); the component core mirrors
jiminy_tpu's op for op and is held at 1e-12 absolute plus 1e-12 relative
(accelerations reach 1e4; XLA reassociates inside its fusions).

The golden rows cannot be held at the repo's golden tolerance (1e-10): after
the feet touch down (about the sixth of the sixteen controller ticks of the
first env step) the standing Atlas amplifies a difference tenfold a tick,
until it saturates, so any two programs that round differently part by about
1e-6 in v and 1e-2 N in the contact forces within the first rows. jiminy_tpu
itself, started with the base height one ulp up or down, ends the first row
7.4e-4 / 1.2e-2 from its own golden and later rows 1.5e-3 to 1.5e-2
(`_reference_reach`). The port therefore is held, row by row, to the reach
of rounding: its distance from the golden must stay within GOLDEN_REACH
times the larger distance of its own two such witnesses (`_witness_rows`),
and within GOLDEN_REACH times jiminy_tpu's, plus the golden tolerance. On the
CPU the port's distance is at most 2.7 times its own witnesses' and 2.5
times jiminy_tpu's over the ten rows (both paths alike); GOLDEN_REACH is
about twice that. tests/test_torch_atlas_ticks.py holds the same path tick
by tick, each tick started from jiminy_tpu's state, at 1e-12.
"""

import functools

import numpy as np
import pytest
import torch

from golden_configs import read_golden
from jiminy_torch import convert
from jiminy_torch.engine.hardware import MOTOR_ARRAY_FIELDS
from jiminy_torch.engine.robot import Robot as TRobot
from jiminy_torch.envs import assets as t_assets
from jiminy_torch.envs import builders_bipeds as t_bipeds
from jiminy_torch.envs import make as t_make
from jiminy_torch.models.model import ARRAY_FIELDS, META_FIELDS
from jiminy_torch.models.urdf import parse_collision_geometries as t_parse
from jiminy_torch.ops import cdyn as t_cdyn
from jiminy_torch.testing import perturbed_states
from jiminy_tpu.engine.robot import Robot as JRobot
from jiminy_tpu.envs import make as j_make
from jiminy_tpu.models.urdf import parse_collision_geometries as j_parse
from jiminy_tpu.ops import cdyn as j_cdyn

import jax
import jax.numpy as jnp

IDS = ("atlas-reduced-pid", "atlas-pid")
SIZES = {"atlas-reduced-pid": (19, 18, 13, 12, 12), "atlas-pid": (37, 36, 31, 12, 30)}
GRAV = (0.0, 0.0, -9.81)
GOLDEN_ATOL = 1e-10
GOLDEN_REACH = 5.0
WITNESS_MOVES = (np.inf, -np.inf)  # the base height moved one ulp up, down


@pytest.fixture(scope="module")
def envs():
    return {name: (t_make(name, device="cpu", dtype=torch.float64), j_make(name)) for name in IDS}


def _assert_same_model(t_model, j_model):
    for f in META_FIELDS:
        assert tuple(np.atleast_1d(getattr(t_model, f))) == tuple(
            np.atleast_1d(getattr(j_model, f))
        ), f
    for f in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(t_model, f), np.asarray(getattr(j_model, f)),
                                      err_msg=f)


def test_collision_geometries_match_jax():
    path = t_assets.urdf_path("atlas")
    got, ref = t_parse(path), j_parse(path)
    assert set(got) == set(ref) and {"l_foot", "r_foot", "l_hand"} <= set(got)
    for link, specs in got.items():
        assert len(specs) == len(ref[link]), link
        for a, b in zip(specs, ref[link]):
            assert a["geometry"] == b["geometry"] and a["frame_name"] == b["frame_name"]
            for key in ("size", "radius", "length"):
                assert a.get(key) == b.get(key), (link, key)
            for x, y in zip(a["origin"], b["origin"]):
                np.testing.assert_array_equal(x, y)
    assert [s["geometry"] for s in got["l_foot"]] == ["box", "box"]


@pytest.mark.parametrize("name", IDS)
def test_atlas_robot_matches_jax(envs, name):
    t_env, j_env = envs[name]
    tr, jr = t_env.robot, j_env.robot
    nq, nv, nj, nc, nm = SIZES[name]
    assert (tr.nq, tr.nv, tr.model.njoints, len(tr.contact_frame_indices), tr.nmotors) == (
        nq, nv, nj, nc, nm)
    _assert_same_model(tr.model, jr.model)  # armature after the motor fold included
    # 12 contact points: the foot boxes' corners kept on the support hull, 6 a foot
    assert tr.contact_frame_indices == tuple(jr.contact_frame_indices)
    assert tr.contact_radii == tuple(jr.contact_radii) == (0.0,) * nc
    names = [tr.model.frame_names[f] for f in tr.contact_frame_indices]
    assert sum(n.startswith("l_foot_collision") for n in names) == 6
    parents = {tr.model.frame_parents[f] for f in tr.contact_frame_indices}
    assert {tr.model.joint_names[p] for p in parents} == {"l_leg_akx", "r_leg_akx"}
    assert tr.motors.names == jr.motors.names
    assert tr.motors.v_indices == jr.motors.v_indices
    for f in MOTOR_ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tr.motors, f), np.asarray(getattr(jr.motors, f)),
                                      err_msg=f)
    assert np.all(tr.motors.friction_viscous_pos < 0)  # declared, though not enabled
    t_groups, j_groups = dict(tr.sensors.groups()), dict(jr.sensors.groups())
    assert set(t_groups) == set(j_groups) == {"encoder", "effort", "imu", "force"}
    assert len(t_groups["encoder"].names) == len(t_groups["effort"].names) == nm
    assert t_groups["encoder"].q_indices == j_groups["encoder"].q_indices
    assert t_groups["effort"].motor_indices == j_groups["effort"].motor_indices
    assert t_groups["imu"].frame_indices == j_groups["imu"].frame_indices
    assert t_groups["force"].contact_slots == j_groups["force"].contact_slots
    assert [len(s) for s in t_groups["force"].contact_slots] == [6, 6]
    np.testing.assert_array_equal(t_env.env.nominal_q.numpy(), np.asarray(j_env.env.nominal_q))


@pytest.mark.parametrize("name", IDS)
def test_atlas_pd_block_matches_jax(envs, name):
    """The PD gains (`ATLAS_PD_EFFECTIVE` on the motor side) and the whole
    block, carried across from jiminy_tpu's arrays with `convert`."""
    t_env, j_env = envs[name]
    pd, enc = j_env.block, j_env.robot.sensors.encoder
    np.testing.assert_array_equal(t_env.block.kp, np.asarray(pd.kp))
    np.testing.assert_array_equal(t_env.block.kd, np.asarray(pd.kd))
    assert float(np.max(t_env.block.kp)) == 8000.0
    with pytest.raises(KeyError, match="no PD gains for motor"):
        t_bipeds.pd_gains(t_env.robot, {"arm_": (1.0, 0.01)})  # the legs unnamed
    arrays = {
        "dt": pd._dt, "kp": np.asarray(pd.kp), "kd": np.asarray(pd.kd),
        "state_min": np.asarray(pd._state_min), "state_max": np.asarray(pd._state_max),
        "effort_limit": np.asarray(pd._effort_limit), "reduction": np.asarray(enc.reduction),
        "q_indices": enc.q_indices, "v_indices": enc.v_indices, "joint_side": enc.joint_side,
    }
    got = convert.pd_components_from_arrays(arrays)
    ref = t_env.block.component_controller(t_env.env)
    for f in ("dt", "kp", "kd", "smin", "smax", "eff", "red", "q_indices", "v_indices",
              "joint_side"):
        assert getattr(got, f) == getattr(ref, f), f
    assert ref.n_carry == 3 * SIZES[name][4]


def test_atlas_arrays_carry_across(envs):
    """The model and the motor bank dumped from jiminy_tpu build the port's."""
    t_env, j_env = envs["atlas-pid"]
    jm = j_env.robot.model
    arrays = {f: getattr(jm, f) for f in META_FIELDS}
    arrays.update({f: np.asarray(getattr(jm, f), np.float64) for f in ARRAY_FIELDS})
    _assert_same_model(convert.model_from_arrays(arrays), t_env.robot.model)
    m = j_env.robot.motors
    bank = {f: getattr(m, f) for f in convert.MOTOR_META_FIELDS}
    bank.update({f: np.asarray(getattr(m, f)) for f in MOTOR_ARRAY_FIELDS})
    got = convert.motor_bank_from_arrays(bank)
    assert got.names == t_env.robot.motors.names
    for f in MOTOR_ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(t_env.robot.motors, f), err_msg=f)


def _jax_core(j_env):
    robot = j_env.robot
    return j_cdyn.ComponentDynamics(
        robot.model, GRAV, contact_opts=j_env.engine.options.contacts,
        contact_frames=robot.contact_frame_indices, contact_radii=robot.contact_radii,
        bound_gains=j_env.engine._bound_gains,
    )


def test_atlas_plain_core_matches_jax(envs):
    """`atlas-pid`'s accelerations (ABA with armature, damping, penalty
    bounds, 12 spring-damper contacts) and aux outputs, on seeded states with
    feet in the ground and a quarter of the envs past a joint bound."""
    t_env, j_env = envs["atlas-pid"]
    tg, jg = t_env.env.engine._bound_gains, j_env.env.engine._bound_gains
    assert set(tg) == set(jg) and all(tg[k] == pytest.approx(jg[k], rel=1e-13) for k in tg)
    q, v, tau = perturbed_states(t_env, 8, seed=3)
    qj, vj, tj = (jnp.asarray(x.numpy()) for x in (q, v, tau))
    core = t_env.env.engine._cdyn
    ref_core = _jax_core(j_env.env)
    a = core.accel(q, v, tau)
    a_ref = np.asarray(ref_core.accel(qj, vj, tj))
    assert np.abs(a_ref).max() > 1e3
    np.testing.assert_allclose(a.numpy(), a_ref, atol=1e-12, rtol=1e-12)
    imu = t_env.env.engine._imu_frames
    aux = core.aux_outputs(q, v, a, imu_frames=imu)
    aux_ref = ref_core.aux_outputs(qj, vj, jnp.asarray(a_ref), imu_frames=imu)
    for key in ("contact_f_world", "contact_w_local", "contact_depth", "imu_raw"):
        np.testing.assert_allclose(aux[key].numpy(), np.asarray(aux_ref[key]), atol=1e-12,
                                   rtol=1e-12, err_msg=key)


def test_atlas_spring_section_has_wide_depths(envs):
    """The spring kernels' tree: depth levels wider than the 4 lanes of an
    env, each slot's parent one depth up, the penalty bounds on the dofs."""
    t_env, _ = envs["atlas-pid"]
    eng = t_env.env.engine
    c = eng._cdyn.c
    sec = t_cdyn.spring_section(eng._cdyn, eng._build_tau_c())
    nlev, nj = sec[0], c.nj
    lstart = sec[2:3 + nlev]
    jorder = sec[3 + nlev:3 + nlev + nj]
    widths = np.diff(lstart)
    assert sum(widths) == nj == 31 and max(widths) > 4
    depth = {}
    for j in jorder:
        depth[j] = 0 if c.parents[j] < 0 else depth[c.parents[j]] + 1
    assert [depth[j] for j in jorder] == sorted(depth.values())
    assert sec[1] == 1  # motors on distinct dofs: one motor task a lane


def test_atlas_entry_points_refuse_what_is_not_ported(monkeypatch):
    # The procedural look-alikes are ported: each env builds jiminy_tpu's robot
    for name in ("atlas-pid", "ant", "cassie-pid", "digit"):
        t_model = t_make(name, device="cpu", procedural=True).robot.model
        j_model = j_make(name, procedural=True).robot.model
        assert t_model.joint_names == tuple(j_model.joint_names), name
        np.testing.assert_array_equal(t_model.mass, np.asarray(j_model.mass))
    # The toys are ported (ROADMAP.md queue 1 item 8, first half)
    assert t_make("cartpole", device="cpu").action_size == 1
    # The other collision primitives are ported (the hands' spheres, the
    # arms' cylinders: radius-r and rim points as jiminy_tpu builds them),
    # and so are collision pairs (the feet's boxes, box-box SAT)
    urdf = t_assets.urdf_path("atlas")
    for link in ("l_hand", "l_ufarm"):
        tr = TRobot.build(urdf, has_freeflyer=True, collision_bodies=[link])
        jr = JRobot.build(urdf, has_freeflyer=True, collision_bodies=[link])
        assert tr.contact_radii == tuple(jr.contact_radii) and tr.contact_radii
        assert tr.contact_frame_indices == tuple(jr.contact_frame_indices)
        _assert_same_model(tr.model, jr.model)
    pairs = dict(collision_bodies=["l_foot", "r_foot"], collision_pairs=[("l_foot", "r_foot")])
    tr = TRobot.build(urdf, has_freeflyer=True, **pairs)
    jr = JRobot.build(urdf, has_freeflyer=True, **pairs)
    assert tr.collision_pairs_geom == tuple(jr.collision_pairs_geom)
    assert {g[1] for pair in tr.collision_pairs_geom for g in pair} == {"box"}
    # No device and no card: the entry point runs on the card or raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_make("atlas-pid")


def test_collision_bodies_by_link_name_match_jax():
    """Robot.build with link names: the feet (two boxes each) expanded into
    their 16 corners each, radius-0 contact points."""
    urdf = t_assets.urdf_path("atlas")
    bodies = ["l_foot", "r_foot"]
    tr = TRobot.build(urdf, has_freeflyer=True, collision_bodies=bodies)
    jr = JRobot.build(urdf, has_freeflyer=True, collision_bodies=bodies, dtype=jnp.float64)
    _assert_same_model(tr.model, jr.model)
    assert tr.contact_frame_indices == tuple(jr.contact_frame_indices)
    assert len(tr.contact_frame_indices) == 32


def _row(sim, reward, i=None):
    def pick(x):
        x = x if i is None else x[i]
        return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, np.float64)

    return np.concatenate([[float(pick(sim.t))], pick(sim.q), pick(sim.v), [float(pick(reward))],
                           pick(sim.contact_forces).ravel()])


def _witness_rows(fused: bool, n_rows: int):
    """The port's golden rows (env 0) and, row by row, the largest distance
    from them of its witnesses (envs 1, 2: the base height moved one ulp up,
    down; the other nonzero coordinate, the quaternion's w = 1, moves neither
    program)."""
    env = t_make("atlas-reduced-pid", device="cpu", dtype=torch.float64)
    env.use_fused_rollout = fused
    st, _ = env.reset(batch_size=1 + len(WITNESS_MOVES))
    q = st.sim.q.clone()
    for w, to in enumerate(WITNESS_MOVES, 1):
        q[w, 2] = torch.nextafter(q[w, 2], torch.tensor(to, dtype=q.dtype))
    st = st.replace(sim=st.sim.replace(q=q))
    action = torch.zeros(env.action_size, dtype=torch.float64)
    rows, spread = [], []
    for _ in range(n_rows):
        st, _, reward, terminated, _, _ = env.step(st, action)
        assert not bool(terminated.any())
        own = _row(st.sim, reward, 0)
        rows.append(own)
        spread.append(max(np.abs(_row(st.sim, reward, w) - own).max()
                          for w in range(1, 1 + len(WITNESS_MOVES))))
    return np.stack(rows), np.array(spread)


@functools.lru_cache(maxsize=None)
def _reference_reach(n_rows: int):
    """jiminy_tpu's own one-ulp reach: row by row, the largest distance from
    the golden (which jiminy_tpu reproduces exactly on the CPU) of
    jiminy_tpu started from the golden's reset with the base height moved
    one ulp up or down."""
    env = j_make("atlas-reduced-pid")
    st0, _ = env.reset(jax.random.PRNGKey(4))
    step = jax.jit(env.step)
    action = jnp.zeros(env.action_size)
    golden = read_golden("atlas-reduced-pid")[:n_rows]
    reach = np.zeros(n_rows)
    for to in WITNESS_MOVES:
        q = st0.sim.q.at[2].set(jnp.nextafter(st0.sim.q[2], to))
        st = st0.replace(sim=st0.sim.replace(q=q))
        for k in range(n_rows):
            st, _, reward, _, _, _ = step(st, action)
            reach[k] = max(reach[k], np.abs(_row(st.sim, reward) - golden[k]).max())
    return reach


def _check_golden(fused: bool, n_rows: int):
    golden = read_golden("atlas-reduced-pid")[:n_rows]
    got, spread = _witness_rows(fused, n_rows)
    reach = _reference_reach(n_rows)
    dist = np.abs(got - golden).max(axis=1)
    assert np.all(spread < 1.0) and np.all(reach < 1.0), (spread, reach)  # rounding's reach stays small
    assert np.all(dist <= GOLDEN_REACH * spread + GOLDEN_ATOL), (dist, spread)
    assert np.all(dist <= GOLDEN_REACH * reach + GOLDEN_ATOL), (dist, reach)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_period"])
def test_atlas_reduced_pid_first_golden_row_within_rounding_reach(fused):
    _check_golden(fused, 1)


@pytest.mark.slow
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_period"])
def test_atlas_reduced_pid_all_golden_rows_within_rounding_reach(fused):
    _check_golden(fused, len(read_golden("atlas-reduced-pid")))
