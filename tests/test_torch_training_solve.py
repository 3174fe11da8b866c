"""Full PPO solves on the port (port of tests/test_training_solve.py; the
reference CI's `test_training_toys_models.py:28-41`: the cartpole and the
acrobot solved within the 200k-timestep budget).

Marked slow like its jiminy_tpu counterpart: each solve trains 144k env
steps, 4 envs at a time (36,000 batched steps of the generic path), on the
card when one is present, else on the CPU. Run it with
`python -m pytest --noconftest -s -m slow tests/test_torch_training_solve.py`
(`--noconftest`: the repo conftest imports jax and skips slow tests).

Hyperparameters are the reference SB3 CI configs (`_BASE`, as jiminy_tpu's
test has them). jiminy_tpu's own record met the cartpole bar on 2 of its 3
training seeds (42 / 43 / 44 gave 372.8 / 252.6 / 500.0), and the port
draws other streams, so each solve must hold on at least 2 of the seeds
42, 43 and 44: the acrobot's greedy policy reaches the half-height target
on >= 4 of 5 evaluation episodes; the cartpole's greedy episodes average
more than 300 steps with one full 500.
"""

import numpy as np
import pytest
import torch

from jiminy_torch.envs import make
from jiminy_torch.rl import PPOConfig, evaluate_batch, policy_from_params, train
from jiminy_torch.rl.networks import ActorCritic

_BASE = dict(
    n_envs=4, n_steps=4000, n_epochs=20, n_minibatches=64,
    gamma=0.98, gae_lambda=0.94, clip_eps=0.3, vf_coef=0.04,
    ent_coef=0.01, lr=5e-4, max_grad_norm=1.0, hidden=(64, 64),
    log_std_init=1.0, target_kl=0.1, anneal_lr=True,
)
SEEDS = (42, 43, 44)


def _device():
    return "cuda" if torch.cuda.is_available() else "cpu"


def _train(env_name, seed):
    device = _device()
    cfg = PPOConfig(total_iterations=9, **_BASE)
    assert cfg.n_envs * cfg.n_steps * cfg.total_iterations <= 150_000

    print(f"{env_name} seed {seed}: {cfg.total_iterations} iterations of {cfg.n_envs} envs x "
          f"{cfg.n_steps} steps on {device}", flush=True)

    def progress(i, state, metrics):
        print(f"{env_name} seed {seed} iteration {i}: episode_length_mean "
              f"{metrics['episode_length_mean']:.1f}", flush=True)

    state, hist = train(make(env_name, device=device), cfg,
                        generator=torch.Generator(device).manual_seed(seed), callback=progress)
    return cfg, state, hist


def _greedy_lengths(env_name, state, cfg, n_episodes=5, max_t=500):
    """Greedy episodes, one batch of envs: (lengths, terminated)."""
    device = _device()
    env = make(env_name, device=device)
    obs_dim = state.last_obs.shape[-1]
    net = ActorCritic(obs_dim, env.action_size, cfg.hidden, log_std_init=cfg.log_std_init,
                      device=device)
    stats = evaluate_batch(env, policy_from_params(net, state.params), n_episodes=n_episodes,
                           n_steps=max_t, generator=torch.Generator(device).manual_seed(100))
    return stats["episodes"]["length"].tolist(), stats["episodes"]["terminated"].tolist()


@pytest.mark.slow
def test_ppo_solves_acrobot():
    """Acrobot swing-up: the episode length collapses as successes
    accumulate, and the greedy policy reaches the target on >= 4 of 5
    episodes; on at least 2 of the 3 seeds."""
    results = {}
    for seed in SEEDS:
        cfg, state, hist = _train("acrobot", seed)
        lens, terminated = _greedy_lengths("acrobot", state, cfg)
        n_solved = sum(1 for ln, te in zip(lens, terminated) if te and ln < 500)
        signal = hist[-1]["episode_length_mean"] < 0.6 * hist[0]["episode_length_mean"]
        results[seed] = (signal and n_solved >= 4, lens, terminated)
        print(f"acrobot seed {seed}: {results[seed]}", flush=True)
    assert sum(ok for ok, *_ in results.values()) >= 2, results


@pytest.mark.slow
def test_ppo_solves_cartpole():
    """Cartpole balance: greedy episodes last the bulk of the 500-step
    horizon (mean > 300, one full 500); on at least 2 of the 3 seeds."""
    results = {}
    for seed in SEEDS:
        cfg, state, hist = _train("cartpole", seed)
        lens, _ = _greedy_lengths("cartpole", state, cfg)
        signal = hist[-1]["episode_length_mean"] > 5 * hist[0]["episode_length_mean"]
        results[seed] = (signal and np.mean(lens) > 300 and max(lens) == 500, lens)
        print(f"cartpole seed {seed}: {results[seed]}", flush=True)
    assert sum(ok for ok, *_ in results.values()) >= 2, results
