#!/usr/bin/env python3
"""How far jiminy_tpu's PPO cartpole bar depends on the training seed.

    JAX_PLATFORMS=cpu python3 ppo_seed_spread.py [SEED ...]   (default 42 43 44)

Runs jiminy_tpu's `tests/test_training.py::test_ppo_learns_cartpole` on the
CPU at float64 (as its conftest runs it: 32 envs x 64 steps, 4 x 4, 35
iterations, lr 3e-4, ent 0.01) for each seed, then its 5 greedy episodes
(resets from PRNGKey(100 + i)), and prints per seed the episode-length
curve's ends, the greedy lengths and their mean against the test's bar of
100 steps. It is the reference the port's `chip_smoke.py` phase 16 is read
against; it imports jiminy_tpu and JAX, so it is not part of the port.
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from jiminy_tpu.envs import make  # noqa: E402
from jiminy_tpu.rl import PPOConfig, train  # noqa: E402
from jiminy_tpu.rl.networks import ActorCritic  # noqa: E402


def greedy_lengths(params, cfg, n=5, max_t=500):
    env = make("cartpole")
    net = ActorCritic(1, hidden=cfg.hidden)
    step = jax.jit(env.step)
    lengths = []
    for i in range(n):
        st, obs = env.reset(jax.random.PRNGKey(100 + i))
        for t in range(max_t):
            mean, _, _ = net.apply(params, obs)
            st, obs, _, te, tr, _ = step(st, mean)
            if bool(te) or bool(tr):
                break
        lengths.append(t + 1)
    return lengths


def main(seeds):
    cfg = PPOConfig(n_envs=32, n_steps=64, n_epochs=4, n_minibatches=4,
                    total_iterations=35, lr=3e-4, ent_coef=0.01)
    for seed in seeds:
        t0 = time.perf_counter()
        state, hist = train(make("cartpole"), cfg, key=jax.random.PRNGKey(seed))
        lengths = greedy_lengths(state.params, cfg)
        mean = float(np.mean(lengths))
        print(f"seed {seed}: episode_length_mean first {hist[0]['episode_length_mean']:.1f} last "
              f"{hist[-1]['episode_length_mean']:.1f}; greedy lengths {lengths}, mean {mean:.1f} "
              f"({'over' if mean > 100 else 'not over'} the bar of 100); "
              f"{time.perf_counter() - t0:.1f} s on the CPU", flush=True)


if __name__ == "__main__":
    main([int(s) for s in sys.argv[1:]] or [42, 43, 44])
