"""Evaluation of the port's policies (`jiminy_torch.rl.evaluate`; ports of
tests/test_training.py's evaluation and temporal-barrier cases): a batch of
episodes as one batch of envs, one episode with its trajectory, a policy
from trained parameters, and the temporal barrier's effect on the loss."""

import numpy as np
import pytest
import torch

from jiminy_torch.envs import make
from jiminy_torch.gym import FlattenObservation
from jiminy_torch.rl import PPOConfig, evaluate, evaluate_batch, make_train, policy_from_params
from jiminy_torch.rl.networks import ActorCritic


def _pendulum(horizon):
    return make("pendulum", horizon=horizon, device="cpu", dtype=torch.float64)


def test_evaluate_batch_multi_episode():
    env = _pendulum(12)
    stats = evaluate_batch(env, lambda obs, g: torch.zeros(env.action_size, dtype=torch.float64),
                           n_episodes=8, n_steps=20, generator=torch.Generator().manual_seed(0))
    eps = stats["episodes"]
    assert eps["return"].shape == (8,)
    # horizon=12 truncates every episode at 12 of the 20 steps
    np.testing.assert_array_equal(eps["length"], 12)
    assert stats["length_std"] == 0.0 and stats["terminated_frac"] == 0.0
    np.testing.assert_allclose(stats["return_mean"], eps["return"].mean())
    # Distinct draws give distinct trajectories and returns
    assert np.unique(eps["return"]).size > 1


def test_evaluate_rollout_and_trajectory():
    env = _pendulum(10)
    traj, stats = evaluate(env, lambda obs, g: torch.zeros(env.action_size, dtype=torch.float64),
                           n_steps=40, generator=torch.Generator().manual_seed(1))
    assert stats["length"] == 10 and not stats["terminated"]  # truncated at the horizon
    assert np.isfinite(stats["return"]) and stats["return"] < 0.0
    assert len(traj) == 10 and traj.qs.shape == (10, 1) and traj.vs.shape == (10, 1)
    np.testing.assert_allclose(np.diff(traj.times), env.step_dt, rtol=1e-12)
    mid = traj.state_at(0.5 * (traj.times[3] + traj.times[4]))
    np.testing.assert_allclose(mid.q, 0.5 * (traj.qs[3] + traj.qs[4]), rtol=1e-12)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 14"):
        evaluate(env, lambda obs, g: None, record_gif="roll.gif")


def test_policy_from_params():
    net = ActorCritic(3, 1, (8, 8), log_std_init=0.0, dtype=torch.float64, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    params = {k: p.detach() for k, p in net.named_parameters()}
    obs = torch.randn((5, 3), dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    greedy = policy_from_params(net, params)(obs)
    torch.testing.assert_close(greedy, net(obs)[0].detach(), rtol=0, atol=0)
    noisy = policy_from_params(net, params, deterministic=False)
    a = noisy(obs, torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, noisy(obs, torch.Generator().manual_seed(2)), rtol=0, atol=0)
    assert a.shape == greedy.shape and not torch.equal(a, greedy)


def test_temporal_barrier_regularizer():
    """The temporal barrier (reference `rllib/ppo.py:664-675`): an exact zero
    under its threshold, a penalty on any action change at threshold 0."""
    env = FlattenObservation(_pendulum(8))
    base = dict(n_envs=4, n_steps=8, n_epochs=1, n_minibatches=1, total_iterations=1,
                hidden=(8, 8))
    cfgs = [
        PPOConfig(**base),
        PPOConfig(temporal_barrier_reg=1.0, temporal_barrier_threshold=1e9, **base),
        PPOConfig(temporal_barrier_reg=1.0, temporal_barrier_threshold=0.0,
                  temporal_barrier_scale=10.0, **base),
    ]
    losses = []
    for cfg in cfgs:
        init_fn, train_step = make_train(env, cfg)
        _, metrics = train_step(init_fn(torch.Generator().manual_seed(0)))
        losses.append(float(metrics["loss"]))
    assert abs(losses[0] - losses[1]) < 1e-9  # an inactive barrier is an exact zero
    assert losses[2] > losses[1] + 1e-6  # a zero threshold penalizes any change
