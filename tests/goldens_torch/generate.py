"""Write the toys' golden initial states (`toy_initial_states.json`), the
ant's first env step (`ant_first_step.json`) and jiminy_tpu's constraint-mode
Atlas and ant with its bounds as rows (`atlas_cm_first_step.json`).

    python tests/goldens_torch/generate.py [toys] [ant] [atlas_cm]

(no argument: all three; the last takes some 40 minutes on one CPU.)

For each toy env id of `tests/golden_configs.py` (cartpole; acrobot and
pendulum), jiminy_tpu's `env.reset(jax.random.PRNGKey(seed + 1000 * i))`
draws q0 and v0 from the state key of the reset's four-way split; they are
written at float64 exactly, as hex floats. The port's golden checks start
from them (`reset_at(q0, v0)`): the card's machine has no JAX to draw them.

For the ant, jiminy_tpu's `make("ant")` in its two contact modes (the
default spring-damper contacts, and `ContactModel.CONSTRAINT`) at float64
on the CPU resets one env and takes one step with the seeded action
`ANT_ACTION`; the state after it is written as hex floats.

For `atlas-reduced-pid` and `atlas-pid` in constraint mode (ground contacts
and joint bounds as PGS rows, the options of the port's
`testing.constraint_mode_options`), jiminy_tpu at float64 on the CPU gives:
- on two states from the port's `testing.constrained_inputs` (seed 21,
  written with them): one constrained evaluation of its component core
  (accelerations, multipliers, depths, active sets) and one RK4 substep of a
  period with its extras, eagerly under `jax.disable_jit()` with
  `use_fast_dynamics="always"` (the core the port's kernels mirror);
- from its reset, the first controller period through `Engine.step` (the
  PD block's first command) and the first env step with zero actions,
  through its default CPU engine.
For the ant with its joint bounds as rows (44 rows), one RK4 substep of its
component core on `constrained_inputs` (seed 22).
"""

import json
import os
import sys

import jax
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PATH = os.path.join(HERE, "toy_initial_states.json")
ANT_PATH = os.path.join(HERE, "ant_first_step.json")
TOY_CONFIGS = ("cartpole", "acrobot_pendulum")
ANT_ACTION = np.random.default_rng(12).uniform(-1.0, 1.0, size=8)  # motor torques, |u| <= 1
ANT_FIELDS = ("q", "v", "a", "contact_forces", "lam")


def initial_states() -> dict:
    """{env_id: {"seed", "n_rows", "q0", "v0"}}, q0 and v0 as hex floats."""
    jax.config.update("jax_enable_x64", True)
    tests = os.path.dirname(HERE)
    for p in (tests, os.path.dirname(tests)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from golden_configs import CONFIGS
    from jiminy_tpu.envs import make

    out = {}
    for name in TOY_CONFIGS:
        env_ids, n_steps, _, seed = CONFIGS[name]
        env_ids = (env_ids,) if isinstance(env_ids, str) else env_ids
        for i, env_id in enumerate(env_ids):
            env = make(env_id)
            key = seed + 1000 * i
            k_state = jax.random.split(jax.random.PRNGKey(key), 4)[0]
            q0, v0 = env._sample_state(k_state)
            out[env_id] = {
                "seed": key,
                "n_rows": n_steps,
                "q0": [float(x).hex() for x in np.asarray(q0, np.float64)],
                "v0": [float(x).hex() for x in np.asarray(v0, np.float64)],
            }
    return out


def ant_first_step() -> dict:
    """{mode: {field: hex floats}} of jiminy_tpu's ant after one env step."""
    jax.config.update("jax_enable_x64", True)
    from jiminy_tpu.engine.config import ContactModel
    from jiminy_tpu.envs import make

    out = {}
    for mode, kw in (("spring_damper", {}), ("constraint", {"contact_model": ContactModel.CONSTRAINT})):
        env = make("ant", **kw)
        st, _ = env.reset(jax.random.PRNGKey(0))
        st, _, reward, _, _, _ = env.step(st, jax.numpy.asarray(ANT_ACTION))
        sim = st.sim
        rec = {f: [float(x).hex() for x in np.asarray(getattr(sim, f), np.float64).ravel()]
               for f in ANT_FIELDS}
        rec["reward"] = float(reward).hex()
        out[mode] = rec
    return out


ATLAS_CM_PATH = os.path.join(HERE, "atlas_cm_first_step.json")
ATLAS_CM_IDS = ("atlas-reduced-pid", "atlas-pid")
STATE_FIELDS = ("q", "v", "a", "contact_forces", "lam")


def _hex(x):
    """Hex floats of an array, nested lists by its shape."""
    x = np.asarray(x, np.float64)
    return float(x).hex() if x.ndim == 0 else [_hex(r) for r in x]


def _j_core(j_eng):
    """jiminy_tpu's constrained component core of one substep
    (`make_constrained_period_integrator`'s closures), as its engine builds
    it in constraint contact mode."""
    from jiminy_tpu.engine import solver

    o = j_eng.options
    omega = 2.0 * np.pi * o.contacts.stabilization_freq
    return solver.make_constrained_period_integrator(
        j_eng._cdyn_cm, j_eng._build_tau_c(), {}, j_eng.tick_period / j_eng.n_substeps, 1, "rk4",
        j_eng.cset, j_eng.ground_fn, omega * omega, 2.0 * omega, o.contacts.transition_eps,
        o.contacts.friction, o.contacts.torsion, o.stepper.pgs_regularization,
        o.stepper.pgs_iter_max, n_cmd=j_eng.robot.nmotors, imu_frames=j_eng._imu_frames,
        stage_warm_start=o.stepper.pgs_stage_warm_start, _return_core=True,
    )


def _core_record(j_eng, q, v, cc, substep=True):
    """Inputs, one constrained evaluation and (with `substep`) one RK4
    substep with its extras of jiminy_tpu's core, eagerly."""
    import jax.numpy as jnp

    core = _j_core(j_eng)

    def comps(x):
        x = jnp.asarray(np.asarray(x, np.float64))
        return [x[..., i] for i in range(x.shape[-1])]

    rec = {"q": _hex(q), "v": _hex(v), "cc": _hex(cc)}
    with jax.disable_jit():
        acc, lam, _, depth, cact, bact = core["accel"](comps(q), comps(v), comps(cc), jnp.float64)
        rec["eval"] = {
            "accel": _hex(np.stack(acc, -1)), "lam": _hex(np.stack(lam, -1)),
            "depth": _hex(np.stack(depth, -1)),
            "cact": _hex(np.stack([np.asarray(a, np.float64) for a in cact], -1)),
            "bact": _hex(np.stack([np.asarray(a, np.float64) for a in bact], -1)),
        }
        if substep:
            qc, vc, ccl = core["substep"](comps(q), comps(v), comps(cc))
            extras = core["final_outputs"](qc, vc, ccl)
            rec["substep"] = {"q": _hex(np.stack(qc, -1)), "v": _hex(np.stack(vc, -1)),
                              "extras": _hex(np.stack([np.broadcast_to(e, q.shape[:-1])
                                                       for e in extras], -1))}
    return rec


def _j_constraint_env(name, **kw):
    """jiminy_tpu's env `name` with ground contacts and joint bounds as PGS
    rows (the port's `testing.constraint_mode_options`)."""
    import dataclasses

    from jiminy_tpu.engine.config import ContactModel
    from jiminy_tpu.envs import make

    o = make(name).env.engine.options
    return make(name, options=o.replace(
        contacts=dataclasses.replace(o.contacts, model=ContactModel.CONSTRAINT),
        joint_bounds_mode="constraint", **kw))


def atlas_cm() -> dict:
    """{env id: record} of jiminy_tpu's Atlas in constraint mode, and
    {"ant-bounds": record} of its ant with the bounds as rows."""
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from jiminy_torch.engine.config import ContactModel as TContactModel
    from jiminy_torch.envs import make as t_make
    from jiminy_torch.testing import constrained_inputs, constraint_mode_options
    from jiminy_tpu.engine.config import ContactModel
    from jiminy_tpu.envs import make

    out = {}
    for name in ATLAS_CM_IDS:
        base = t_make(name, device="cpu", dtype=torch.float64).engine.options
        t_env = t_make(name, device="cpu", dtype=torch.float64,
                       options=constraint_mode_options(base))
        q, v, cmd, sol = (x.numpy() for x in constrained_inputs(t_env, 2, seed=21))
        core_env = _j_constraint_env(name, use_fast_dynamics="always")
        rec = _core_record(core_env.env.engine, q, v, np.concatenate([cmd, sol], -1))
        env = _j_constraint_env(name)
        st, _ = env.reset(jax.random.PRNGKey(0))
        action = jnp.zeros(env.action_size)
        cmd0, _ = env.block.compute(action, env.env.observe(st), st.blocks[env.block.name])
        sim = jax.jit(env.env.engine.step)(st.sim, cmd0)
        rec["period"] = {f: _hex(np.asarray(getattr(sim, f)).ravel()) for f in STATE_FIELDS}
        st, _, reward, _, _, _ = jax.jit(env.step)(st, action)
        rec["step"] = {f: _hex(np.asarray(getattr(st.sim, f)).ravel()) for f in STATE_FIELDS}
        rec["step"]["reward"] = _hex(reward)
        out[name] = rec
        print(f"{name}: done", flush=True)
    t_opts = t_make("ant", device="cpu", dtype=torch.float64,
                    contact_model=TContactModel.CONSTRAINT).engine.options
    t_env = t_make("ant", device="cpu", dtype=torch.float64,
                   options=t_opts.replace(joint_bounds_mode="constraint"))
    q, v, cmd, sol = (x.numpy() for x in constrained_inputs(t_env, 2, seed=22))
    j_opts = make("ant", contact_model=ContactModel.CONSTRAINT).engine.options
    j_env = make("ant", options=j_opts.replace(joint_bounds_mode="constraint",
                                               use_fast_dynamics="always"))
    out["ant-bounds"] = _core_record(j_env.engine, q, v, np.concatenate([cmd, sol], -1))
    return out


def _write(path, data):
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    which = sys.argv[1:] or ["toys", "ant", "atlas_cm"]
    if "toys" in which:
        _write(PATH, initial_states())
    if "ant" in which:
        _write(ANT_PATH, ant_first_step())
    if "atlas_cm" in which:
        sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
        _write(ATLAS_CM_PATH, atlas_cm())
