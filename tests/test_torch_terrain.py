"""The port's procedural terrain (`jiminy_torch.utils.terrain`) against
jiminy_tpu's on the CPU at float64: the noises, every ground generator, the
heightmap algebra, the packed form and its plain evaluation; then a point
mass at rest on Perlin ground (tests/test_terrain.py::test_engine_on_perlin_ground).

Points are drawn with numpy from a seed and handed to both packages. Heights
and the components of the normal are held at 1e-12: the port's forward-mode
arithmetic mirrors each op of jiminy_tpu's `jax.jvp` of the same primal,
including JAX's even split at a tie of `minimum` / `maximum`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_torch import convert
from jiminy_torch.utils import terrain as tt
from jiminy_tpu.utils import terrain as jt

TOL = 1e-12


def _params(mod):
    """tests/test_terrain.py's generators, and jiminy_tpu's fused-terrain
    case (tests/test_cdyn.py), in module `mod`."""
    g = {
        "stairs": mod.periodic_stairs_ground(0.4, 0.08, 3, orientation=0.3),
        "perlin": mod.random_perlin_ground(1.3, 0.15, seed=11),
        "periodic_perlin": mod.periodic_perlin_ground(0.8, 4.0, 0.1, seed=2),
        "unidirectional": mod.unidirectional_random_perlin_ground(1.1, 0.12, orientation=0.7,
                                                                  seed=9),
        "ties": mod.periodic_stairs_ground(0.5, 0.1, 2, orientation=0.0),
        "perlin_2oct": mod.random_perlin_ground(0.7, 0.2, seed=1, octaves=2),
    }
    g["sum"] = mod.sum_heightmaps([g["stairs"], g["perlin"]])
    g["merge"] = mod.merge_heightmaps([g["perlin"], g["periodic_perlin"]])
    g["sum_of_merge"] = mod.sum_heightmaps([g["merge"], g["unidirectional"], g["ties"]])
    g["rough"] = mod.sum_heightmaps([
        mod.random_perlin_ground(wavelength=1.5, height_max=0.05, seed=3),
        mod.periodic_stairs_ground(0.4, 0.03, 3, orientation=0.5),
    ])
    return g


GROUNDS = list(_params(tt))


def _points(seed=4, n=96):
    xy = np.random.default_rng(seed).uniform(-3.0, 3.0, size=(n, 2))
    # Exact ties: stairs (0.5, 0.1, 2, orientation 0) at u = 1.0 (phase ==
    # step_number) and at u = 0.0, 2.0, and lattice corners of the noises
    ties = np.array([[1.0, 0.3], [0.0, -0.2], [2.0, 1.7], [-1.0, 0.0], [1.3, 1.3],
                     [0.99 * 0.5, 0.0], [0.5, 0.5]])
    return np.concatenate([xy, ties], axis=0)


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, name):
    a, b = np.broadcast_arrays(_np(a), _np(b))
    np.testing.assert_allclose(a, b, rtol=0.0, atol=TOL, err_msg=name)


@pytest.fixture(scope="module")
def grounds():
    return _params(tt), _params(jt)


@pytest.mark.parametrize("name", GROUNDS)
def test_ground_matches_jiminy_tpu(grounds, name):
    """fn(xy) and height_components of every generator and the algebra."""
    port, ref = grounds[0][name], grounds[1][name]
    xy = _points()
    h, n = port(torch.as_tensor(xy))
    h_ref, n_ref = ref(jnp.asarray(xy))
    _close(h, h_ref, f"{name} h")
    _close(n, n_ref, f"{name} n")
    hc, nc = port.height_components(torch.as_tensor(xy[:, 0]), torch.as_tensor(xy[:, 1]))
    hc_ref, nc_ref = ref.height_components(jnp.asarray(xy[:, 0]), jnp.asarray(xy[:, 1]))
    _close(hc, hc_ref, f"{name} components h")
    for k in range(3):
        _close(nc[k], nc_ref[k], f"{name} components n{k}")


def test_ties_take_half_the_tangent():
    """JAX splits a tie of min/max evenly: jnp.maximum(x, 1.) and
    jnp.clip(x, 0., 1.) at x = 1 have derivative 0.5; the port's ops too."""
    one = torch.tensor([1.0], dtype=torch.float64)
    d = tt.Dual(one, torch.ones_like(one), torch.zeros_like(one))
    assert float(tt._maximum(d, 1.0).dx) == 0.5
    assert float(tt._minimum(d, 1.0).dx) == 0.5
    assert float(tt._clip(d, 0.0, 1.0).dx) == 0.5
    assert float(tt._clip(d * 0.0, 0.0, 1.0).dx) == 0.0  # tangent 0 stays 0
    assert float(tt._clip(d - 1.0, 0.0, 1.0).dx) == 0.5
    import jax

    assert float(jax.grad(lambda x: jnp.maximum(x, 1.0))(1.0)) == 0.5
    assert float(jax.grad(lambda x: jnp.clip(x, 0.0, 1.0))(1.0)) == 0.5
    # the stairs at the tie u = 1.0 of (0.5, 0.1, 2): phase == step_number
    g_t, g_j = tt.periodic_stairs_ground(0.5, 0.1, 2), jt.periodic_stairs_ground(0.5, 0.1, 2)
    h, n = g_t.height_components(torch.tensor([1.0, 0.995, 0.2475], dtype=torch.float64),
                                 torch.zeros(3, dtype=torch.float64))
    h_r, n_r = g_j.height_components(jnp.asarray([1.0, 0.995, 0.2475]), jnp.zeros(3))
    _close(h, h_r, "tie h")
    _close(n[0], n_r[0], "tie nx")


@pytest.mark.parametrize("name", ["perlin1", "perlin2", "perlin3", "octave_perlin1",
                                  "octave_perlin2", "octave_perlin3"])
def test_noises_match_jiminy_tpu(name):
    rng = np.random.default_rng(7)
    xs = [rng.uniform(-20.0, 20.0, size=200) for _ in range(3)]
    xs[0][:4] = [0.0, 2.0, -3.0, 1e3]
    nargs = int(name[-1])
    kw = dict(seed=5) if name.startswith("perlin") else dict(seed=5, octaves=3,
                                                             persistence=0.6)
    out = getattr(tt, name)(*(torch.as_tensor(x) for x in xs[:nargs]), **kw)
    ref = getattr(jt, name)(*(jnp.asarray(x) for x in xs[:nargs]), **kw)
    _close(out, ref, name)
    assert float(torch.abs(out).max()) > 0.05


def test_hash_matches_uint32_arithmetic():
    rng = np.random.default_rng(1)
    ix = rng.integers(-2**31, 2**31 - 1, size=4000)
    iy = rng.integers(-2**31, 2**31 - 1, size=4000)
    h = tt._hash2(torch.as_tensor(ix), torch.as_tensor(iy), 0xDEADBEEF)
    ref = jt._hash2(jnp.asarray(ix, jnp.int32), jnp.asarray(iy, jnp.int32), 0xDEADBEEF)
    np.testing.assert_array_equal(_np(h), np.asarray(ref).astype(np.int64))
    f = tt._u32_to_float(h, torch.float32)
    np.testing.assert_array_equal(_np(f), np.asarray(ref).astype(np.float32))


@pytest.mark.parametrize("name", GROUNDS)
def test_eval_packed_matches_jiminy_tpu(grounds, name):
    """The plain version of the device function on the packed buffers."""
    ti, tf = tt.pack_ground(grounds[0][name])
    xy = _points(seed=9)
    h, n = tt.eval_packed(ti, tf, torch.as_tensor(xy[:, 0]), torch.as_tensor(xy[:, 1]))
    h_ref, n_ref = grounds[1][name].height_components(jnp.asarray(xy[:, 0]),
                                                       jnp.asarray(xy[:, 1]))
    _close(h, h_ref, f"{name} packed h")
    for k in range(3):
        _close(n[k], n_ref[k], f"{name} packed n{k}")


def test_pack_ground_layout_and_refusals(grounds):
    g = grounds[0]
    ti, tf = tt.pack_ground(g["rough"])
    assert ti.dtype == torch.int32 and tf.dtype == torch.float64
    ops = ti[tt.TI_HEADER:].reshape(-1, tt.TI_OP).tolist()
    assert ti[:2].tolist() == [3, 2]
    assert [o[0] for o in ops] == [tt.T_PERLIN, tt.T_STAIRS, tt.T_SUM]
    assert ops[0][1:] == [0, 4, 3] and ops[1][1] == 3
    np.testing.assert_array_equal(tf[:3].numpy(), [1.5, 0.05, 1.875])
    np.testing.assert_array_equal(tf[3:].numpy(),
                                  [np.cos(0.5), np.sin(0.5), 2.0 * 3 * 0.4, 0.4, 3.0, 0.03])
    assert tt.pack_ground(g["rough"], dtype=torch.float32)[1].dtype == torch.float32
    # A right-nested sum of five terms needs a stack of five: refused
    leaf = g["perlin"]
    deep = leaf
    for _ in range(4):
        deep = tt.sum_heightmaps([leaf, deep])
    with pytest.raises(ValueError, match="stack"):
        tt.pack_ground(deep)
    ok = tt.sum_heightmaps([leaf, tt.sum_heightmaps([leaf, tt.sum_heightmaps([leaf, leaf])])])
    assert tt.pack_ground(ok)[0][1] == tt.TERRAIN_STACK
    # A user callable, a sampled heightmap's query and a sum with one: no packed form
    user = lambda xy: (xy[..., 0] * 0.0, torch.tensor([0.0, 0.0, 1.0]).expand(xy.shape[:-1] + (3,)))
    _, query = tt.discretize_heightmap(leaf, (-1.0, 1.0), (-1.0, 1.0), 0.25)
    for fn in (user, query, tt.sum_heightmaps([leaf, user]), tt.merge_heightmaps([user, leaf])):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2"):
            tt.pack_ground(fn)
        assert tt.ground_route(fn, "cpu") == "plain"
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2"):
            tt.ground_route(fn, torch.device("cuda", 0))
    assert tt.ground_route(None, torch.device("cuda", 0)) == "flat"
    assert tt.ground_route(g["sum_of_merge"], torch.device("cuda", 0)) == "packed"


def test_discretize_heightmap_matches_jiminy_tpu(grounds):
    port, ref = grounds[0]["rough"], grounds[1]["rough"]
    grid, query = tt.discretize_heightmap(port, (-2.0, 2.0), (-1.5, 1.0), 0.1)
    grid_r, query_r = jt.discretize_heightmap(ref, (-2.0, 2.0), (-1.5, 1.0), 0.1)
    assert grid.shape == grid_r.shape == (41, 26)
    np.testing.assert_allclose(grid, np.asarray(grid_r), rtol=0.0, atol=TOL)
    xy = np.random.default_rng(2).uniform(-2.5, 1.5, size=(80, 2))
    h, n = query(torch.as_tensor(xy))
    h_r, n_r = query_r(jnp.asarray(xy))
    _close(h, h_r, "query h")
    _close(n, n_r, "query n")


def test_fourier_process_from_jiminy_tpu_draws():
    import jax

    ref = jt.PeriodicFourierProcess(jax.random.PRNGKey(3), wavelength=0.6, period=5.0,
                                    num_harmonics=6)
    proc = convert.fourier_process_from_jax(np.asarray(ref.a), np.asarray(ref.b),
                                            np.asarray(ref.freqs), ref.period)
    t = np.random.default_rng(3).uniform(-10.0, 10.0, size=(50,))
    _close(proc(torch.as_tensor(t)), ref(jnp.asarray(t)), "fourier")
    assert isinstance(tt.PeriodicGaussianProcess(torch.Generator().manual_seed(0), 0.6, 5.0)(
        torch.zeros(2, dtype=torch.float64)), torch.Tensor)


def test_point_mass_rests_on_perlin_ground():
    """A point mass dropped on Perlin terrain comes to rest on the surface
    (jiminy_tpu's test: RK4 at 1 ms, here 45 periods of 10 ms, 0.45 s of
    its 0.8 s: the mass touches down at 0.32 s and, critically damped at
    100 rad/s, is at rest within 1e-4 m some 0.08 s later)."""
    from jiminy_torch.engine.engine import Engine
    from jiminy_torch.engine.config import (ContactOptions, EngineOptions, StepperOptions,
                                            WorldOptions)
    from jiminy_torch.engine.robot import Robot
    from jiminy_torch.models.model import build_model

    ground = tt.random_perlin_ground(wavelength=1.5, height_max=0.1, seed=5)
    model = build_model(
        "mass",
        [{"name": "pz", "type": 3, "parent": -1, "axis": np.array([0.0, 0.0, 1.0]),
          "mass": 1.0, "com": np.zeros(3), "inertia": np.zeros((3, 3))}],
        [{"name": "contact", "parent": 0, "placement": (np.eye(3), np.zeros(3))}],
    )
    robot = Robot.build(model, contact_frames=["contact"])
    eng = Engine(robot, EngineOptions(
        contacts=ContactOptions(stiffness=1e4, damping=2e2, friction=0.0, transition_eps=0.0),
        world=WorldOptions(ground_profile=ground), stepper=StepperOptions(dt_max=1e-3),
        controller_update_period=0.01, sensor_update_period=0.01,
    ), device="cpu", dtype=torch.float64)
    assert eng._cdyn is not None and eng._cdyn.ground_fn is ground
    st = eng.reset(torch.tensor([0.5], dtype=torch.float64))
    for _ in range(45):
        st = eng.step(st)
    h0, _ = ground(torch.zeros((1, 2), dtype=torch.float64))
    deflection = 9.81 / 1e4
    assert abs(float(st.q[0]) - (float(h0[0]) - deflection)) < 2e-3
    h0_j, _ = jt.random_perlin_ground(wavelength=1.5, height_max=0.1, seed=5)(jnp.zeros((1, 2)))
    assert abs(float(h0[0]) - float(h0_j[0])) < 1e-15
