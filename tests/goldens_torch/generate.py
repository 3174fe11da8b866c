"""Write the toys' golden initial states (`toy_initial_states.json`) and
the ant's first env step (`ant_first_step.json`).

    python tests/goldens_torch/generate.py

For each toy env id of `tests/golden_configs.py` (cartpole; acrobot and
pendulum), jiminy_tpu's `env.reset(jax.random.PRNGKey(seed + 1000 * i))`
draws q0 and v0 from the state key of the reset's four-way split; they are
written at float64 exactly, as hex floats. The port's golden checks start
from them (`reset_at(q0, v0)`): the card's machine has no JAX to draw them.

For the ant, jiminy_tpu's `make("ant")` in its two contact modes (the
default spring-damper contacts, and `ContactModel.CONSTRAINT`) at float64
on the CPU resets one env and takes one step with the seeded action
`ANT_ACTION`; the state after it is written as hex floats.
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


def _write(path, data):
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    _write(PATH, initial_states())
    _write(ANT_PATH, ant_first_step())
