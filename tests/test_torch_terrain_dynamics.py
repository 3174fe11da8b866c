"""The ground profile through the port's dynamics, against jiminy_tpu on the
CPU at float64: the component core's contacts on terrain (jiminy_tpu's
tests/test_cdyn.py::test_cdyn_terrain_matches_generic), the generic path's
contact forces, the constrained rows and multipliers, and one engine period
of `anymal-pid` in both contact modes (the point mass on Perlin ground is in
tests/test_torch_terrain.py).

The ground is jiminy_tpu's fused-terrain case ("ROUGH": 4-octave Perlin plus
stairs, summed). Inputs are numpy draws from a seed; each env stands at its
own (x, y), lifted by the terrain height there. The port mirrors
jiminy_tpu op for op, so stiff outputs (forces of 1e2-1e4 N, rows) are held
at 1e-12 of their own scale, `max |port - ref| <= tol (1 + max |ref|)`, and
an engine period at 1e-10 of its scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_torch.engine import solver as t_solver
from jiminy_torch.engine.contact import compute_contact_forces as t_contact_forces
from jiminy_torch.envs import make as t_make
from jiminy_torch.ops import kinematics as t_kin
from jiminy_torch.testing import constrained_inputs, constraint_mode_options
from jiminy_torch.utils import terrain as tt
from jiminy_tpu.engine import config as j_config
from jiminy_tpu.engine import solver as j_solver
from jiminy_tpu.engine.contact import compute_contact_forces as j_contact_forces
from jiminy_tpu.envs import make as j_make
from jiminy_tpu.ops import cdyn as j_cdyn
from jiminy_tpu.ops.kinematics import forward_kinematics as j_fk
from jiminy_tpu.utils import terrain as jt

B = 4


def rough(mod):
    return mod.sum_heightmaps([
        mod.random_perlin_ground(wavelength=1.5, height_max=0.05, seed=3),
        mod.periodic_stairs_ground(0.4, 0.03, 3, orientation=0.5),
    ])


ROUGH_T, ROUGH_J = rough(tt), rough(jt)


def _close(a, b, tol, name=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = 1.0 + np.abs(b).max()
    err = np.abs(a - b).max()
    assert err <= tol * scale, f"{name}: {err:.3e} > {tol:g} x {scale:.3e}"


def _on_terrain(q, seed):
    """Each env at its own (x, y) in a 6 m square, lifted by the height there."""
    q = np.array(q, np.float64)
    q[:, :2] = np.random.default_rng(seed).uniform(-3.0, 3.0, size=(q.shape[0], 2))
    h, _ = ROUGH_T(torch.as_tensor(q[:, :2]))
    q[:, 2] += h.numpy()
    return q


@pytest.fixture(scope="module")
def base_options():
    """anymal-pid's engine options in both packages (jiminy_tpu's with its
    component core on: it runs that core only off the CPU unless told to)."""
    t_opts = t_make("anymal-pid", device="cpu", dtype=torch.float64).engine.options
    j_opts = j_make("anymal-pid").env.engine.options.replace(use_fast_dynamics="always")
    return t_opts, j_opts


def _options(base, constraint):
    t_opts = base[0].replace(world=dataclasses.replace(base[0].world, ground_profile=ROUGH_T))
    j_opts = base[1].replace(world=dataclasses.replace(base[1].world, ground_profile=ROUGH_J))
    if constraint:
        t_opts = constraint_mode_options(t_opts)
        j_opts = j_opts.replace(
            contacts=dataclasses.replace(j_opts.contacts, model=j_config.ContactModel.CONSTRAINT),
            joint_bounds_mode="constraint",
        )
    return t_opts, j_opts


@pytest.fixture(scope="module")
def spring(base_options):
    t_opts, j_opts = _options(base_options, constraint=False)
    return (t_make("anymal-pid", device="cpu", dtype=torch.float64, options=t_opts),
            j_make("anymal-pid", options=j_opts))


@pytest.fixture(scope="module")
def constrained(base_options):
    t_opts, j_opts = _options(base_options, constraint=True)
    return (t_make("anymal-pid", device="cpu", dtype=torch.float64, options=t_opts),
            j_make("anymal-pid", options=j_opts))


def _spring_states(env, seed):
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(env.nominal_q, np.float64), (B, 1))
    q[:, 2] += np.array([-0.05, -0.02, 0.0, 0.02])
    q[:, 7:] += rng.normal(size=(B, q.shape[1] - 7)) * 0.1
    v = rng.normal(size=(B, env.robot.nv)) * 0.5
    tau = rng.normal(size=(B, env.robot.nv))
    return _on_terrain(q, seed), v, tau


def test_cdyn_accel_on_rough_matches_jax(spring):
    """jiminy_tpu's test_cdyn_terrain_matches_generic on the port: the
    component core's accelerations and contact forces on ROUGH."""
    t_env, j_env = spring
    cd_t = t_env.engine._cdyn
    assert cd_t.ground_fn is ROUGH_T
    q, v, tau = _spring_states(t_env, 0)
    qdd, fw = cd_t._accel_core(*([x[..., i] for i in range(x.shape[-1])]
                                 for x in map(torch.as_tensor, (q, v, tau))))
    robot = j_env.robot
    cd_j = j_cdyn.ComponentDynamics(
        robot.model, (0.0, 0.0, -9.81), contact_opts=j_env.env.engine.options.contacts,
        contact_frames=robot.contact_frame_indices, contact_radii=robot.contact_radii,
        ground_fn=ROUGH_J, bound_gains=j_env.env.engine._bound_gains,
    )
    out, fw_j = cd_j.accel(*map(jnp.asarray, (q, v, tau)), return_contacts=True)
    fw_t = np.stack([np.stack([np.broadcast_to(np.asarray(c), (B,)) for c in f], -1)
                     for f in fw], axis=-2)
    # Touching the terrain somewhere (otherwise the comparison is vacuous)
    assert np.abs(fw_t).max() > 1.0 and (np.abs(fw_t).max(axis=-1) == 0.0).any()
    _close(np.stack([x.numpy() for x in qdd], -1), out, 1e-12, "qdd")
    _close(fw_t, np.asarray(fw_j), 1e-12, "f_world")
    # the wrapper routes a CPU tensor to the same plain version
    _close(cd_t.accel(*map(torch.as_tensor, (q, v, tau))).numpy(), out, 1e-12, "accel")


def test_generic_contact_forces_on_rough_match_jax(spring):
    t_env, j_env = spring
    q, v, _ = _spring_states(t_env, 1)
    model_t, model_j = t_env.robot.model, j_env.robot.model
    frames = t_env.robot.contact_frame_indices
    opts_t, opts_j = t_env.engine.options.contacts, j_env.env.engine.options.contacts
    out = t_contact_forces(model_t, opts_t, ROUGH_T,
                           t_kin.forward_kinematics(model_t, *map(torch.as_tensor, (q, v))),
                           frames)
    ref = j_contact_forces(model_j, opts_j, ROUGH_J, j_fk(model_j, *map(jnp.asarray, (q, v))),
                           frames)
    assert float(torch.abs(out[1]).max()) > 1.0
    for name, a, b in zip(("fext", "f_world", "w_local", "depth"), out, ref):
        _close(a.numpy(), b, 1e-12, name)


def _comps(x):
    return [x[..., i] for i in range(x.shape[-1])]


def test_constrained_rows_and_multipliers_on_rough_match_jax(constrained):
    t_env, j_env = constrained
    t_eng, j_eng = t_env.engine, j_env.env.engine
    assert t_eng._cdyn_cm.ground_fn is ROUGH_T
    q, v, cmd, sol = (x.numpy() for x in constrained_inputs(t_env, B, seed=0))
    q = _on_terrain(q, 2)
    n, nc, nb = 28, 4, 12
    lam, cact, bact = sol[:, :n], sol[:, n:n + nc] > 0.5, sol[:, n + nc:] > 0.5
    o = t_eng._solver_opts
    cd_t, cd_j = t_eng._cdyn_cm, j_eng._cdyn_cm

    def rows(cd, qc, vc, lib):
        xs = cd._joint_x(qc)
        world = cd._world_placements(xs)
        vel, acc = cd._vel_bias_components(xs, vc)
        masks = ([lib(cact[:, k]) for k in range(nc)], [lib(bact[:, k]) for k in range(nb)])
        if lib is torch.as_tensor:
            return t_solver.constraint_system_components(cd, t_eng.cset, qc, vc, xs, world, vel,
                                                         acc, o.kp, o.kd, o.transition_eps,
                                                         *masks)
        return j_solver.constraint_system_components(cd, j_eng.cset, qc, vc, xs, world, vel, acc,
                                                     ROUGH_J, o.kp, o.kd, o.transition_eps,
                                                     *masks, [])

    def dense(entries):
        if isinstance(entries, (list, tuple)):
            return np.stack([dense(e) for e in entries], axis=-1)
        return np.broadcast_to(np.asarray(entries, np.float64), (B,))

    out = rows(cd_t, _comps(torch.as_tensor(q)), _comps(torch.as_tensor(v)), torch.as_tensor)
    ref = rows(cd_j, _comps(jnp.asarray(q)), _comps(jnp.asarray(v)), jnp.asarray)
    for name, a, b in zip(("rows", "drifts", "basis", "depth"), out[:4], ref[:4]):
        _close(dense(a), dense(b), 1e-12, name)
    np.testing.assert_array_equal(dense(out[4]), dense(ref[4]))
    # The normals are off vertical (the rows' basis is not the flat one)
    normals = dense([b[2] for b in out[2]])
    assert np.abs(normals[..., :2]).max() > 1e-2

    tau = np.zeros_like(v)
    tau[:, 6:] = cmd
    args = (o.kp, o.kd, o.transition_eps, o.friction, o.torsion, o.regularization, o.iter_max)
    acc_t = t_solver.constrained_accel_full_components(
        cd_t, t_eng.cset, *(_comps(torch.as_tensor(x)) for x in (q, v, tau)), *args,
        _comps(torch.as_tensor(cact)), _comps(torch.as_tensor(bact)), _comps(torch.as_tensor(lam)))
    acc_j = j_solver.constrained_accel_full_components(
        cd_j, j_eng.cset, *(_comps(jnp.asarray(x)) for x in (q, v, tau)), ROUGH_J, *args,
        _comps(jnp.asarray(cact)), _comps(jnp.asarray(bact)), [], _comps(jnp.asarray(lam)),
        jnp.float64)
    _close(dense(acc_t[0]), dense(acc_j[0]), 1e-12, "qdd")
    _close(acc_t[1].T.numpy(), dense(acc_j[1]), 1e-12, "lam")
    assert np.abs(acc_t[1].numpy()[n - 4 * nc:]).max() > 1.0  # contact forces act


def _engine_period_matches(t_env, j_env, mode, n_substeps, eager=False):
    """`n_substeps` RK4 substeps of the component core's period integrator
    on `ROUGH`, port against jiminy_tpu within 1e-10 of their scale; with
    `eager`, jiminy_tpu runs under `jax.disable_jit()` (its substep scan
    then loops op by op instead of compiling the fused body)."""
    t_eng, j_eng = t_env.engine, j_env.env.engine
    dt = t_eng.tick_period / t_eng.n_substeps
    if mode == "spring":
        q, v, _ = _spring_states(t_env, 3)
        cmd = np.random.default_rng(3).normal(size=(B, 12)) * 20.0
        out = t_eng._get_period_run("rk4").plain(*map(torch.as_tensor, (q, v, cmd)),
                                                 n_substeps=n_substeps)
        j_run = j_eng._cdyn.make_period_integrator(
            j_eng._build_tau_c(), dt, n_substeps, integrator="rk4", imu_frames=j_eng._imu_frames)
        with jax.disable_jit(eager):
            ref = j_run(*map(jnp.asarray, (q, v, cmd)))
        depth = out[2][:, 18 + 36:18 + 40].numpy()
    else:
        q, v, cmd, sol = (x.numpy() for x in constrained_inputs(t_env, B, seed=4))
        q = _on_terrain(q, 4)
        cc = np.concatenate([cmd, sol], axis=1)
        o = t_eng._solver_opts
        out = t_eng._get_period_run("rk4").plain(*map(torch.as_tensor, (q, v, cc)),
                                                 n_substeps=n_substeps)
        j_run = j_solver.make_constrained_period_integrator(
            j_eng._cdyn_cm, j_eng._build_tau_c(), {}, dt, n_substeps, "rk4", j_eng.cset, ROUGH_J,
            o.kp, o.kd, o.transition_eps, o.friction, o.torsion, o.regularization, o.iter_max,
            n_cmd=12, imu_frames=j_eng._imu_frames, stage_warm_start=True)
        with jax.disable_jit(eager):
            ref = j_run(*map(jnp.asarray, (q, v, cc)))
        depth = out[2][:, 18 + 36:18 + 40].numpy()
    assert (depth < 0.0).any()  # some foot in the terrain
    for name, a, b in zip(("q", "v", "extras"), out, ref):
        _close(a.numpy(), b, 1e-10, f"{mode} {name}")


@pytest.mark.parametrize("mode", ["spring", "constraint"])
def test_engine_period_on_rough_matches_jax(spring, constrained, mode):
    """One engine period of the component core (its period integrator), cut
    to one RK4 substep as tests/test_torch_constrained.py cuts it: jiminy_tpu
    runs op by op here, 12-22 s a substep on this ground (compiling its
    period takes longer). The whole period is the slow variant below."""
    t_env, j_env = spring if mode == "spring" else constrained
    _engine_period_matches(t_env, j_env, mode, 1)


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["spring", "constraint"])
def test_engine_full_period_on_rough_matches_jax(spring, constrained, mode):
    """The whole engine period, all its RK4 substeps (5 for anymal-pid), in
    each contact mode, jiminy_tpu op by op (compiling its five-substep scan
    takes some 30 GB here)."""
    t_env, j_env = spring if mode == "spring" else constrained
    _engine_period_matches(t_env, j_env, mode, t_env.engine.n_substeps, eager=True)
