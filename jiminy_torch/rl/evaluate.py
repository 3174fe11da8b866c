"""Policy evaluation (port of `jiminy_tpu.rl.evaluate`; reference
`rllib/utilities.py:1277-1533` `evaluate_from_runner`): roll a trained
policy, return episode statistics and a replayable `Trajectory`.

A policy is `policy(obs, generator) -> action` on observations with a
leading env axis (B envs, B = 1 in `evaluate`). `evaluate_batch` runs its
episodes as one batch of envs stepped in lock-step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from jiminy_torch.gym.wrappers import flatten_pytree
from jiminy_torch.rl import networks
from jiminy_torch.telemetry.trajectory import Trajectory


def policy_from_params(network, params, deterministic: bool = True) -> Callable:
    """`(obs, generator) -> action` over trained `ActorCritic` parameters
    (`network` gives the activation; `params` are named as its own)."""

    @torch.no_grad()
    def policy(obs, generator=None):
        mean, log_std, _ = networks.apply(params, flatten_pytree(obs, 1), network.activation)
        if deterministic:
            return mean
        return mean + torch.exp(log_std) * torch.randn(
            mean.shape, generator=generator, dtype=mean.dtype, device=mean.device)

    return policy


def evaluate(
    env,
    policy: Callable,
    n_steps: int = 1000,
    generator: Optional[torch.Generator] = None,
    record_gif: Optional[str] = None,
) -> Tuple[Trajectory, Dict[str, Any]]:
    """Roll `policy` for up to `n_steps` env steps from a reset drawn with
    `generator`, until the first termination or truncation.

    Returns (trajectory, stats), stats with `return`, `length` (steps until
    the episode ended, or `n_steps`) and `terminated`.
    """
    if record_gif is not None:
        raise NotImplementedError(
            "record_gif= needs the viewer, not ported yet (ROADMAP.md queue 1 item 14)"
        )
    state, obs = env.reset(1, generator)
    ts, qs, vs, rewards = [], [], [], []
    terminated = False
    for _ in range(n_steps):
        state, obs, reward, term, trunc, _ = env.step(state, policy(obs, generator))
        ts.append(float(state.sim.t[0]))
        qs.append(state.sim.q[0].cpu().numpy())
        vs.append(state.sim.v[0].cpu().numpy())
        rewards.append(float(reward[0]))
        if bool(term[0] | trunc[0]):
            terminated = bool(term[0])
            break
    length = len(ts)
    stats = {"return": float(np.sum(rewards)), "length": length, "terminated": terminated}
    traj = Trajectory(times=np.asarray(ts), qs=np.stack(qs), vs=np.stack(vs), robot=env.robot)
    return traj, stats


def evaluate_batch(
    env,
    policy: Callable,
    n_episodes: int = 16,
    n_steps: int = 1000,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, Any]:
    """`n_episodes` episodes as one batch of envs, reset with `generator`,
    aggregated into mean/std statistics.

    Returns a dict with `return_mean/std`, `length_mean/std`,
    `terminated_frac`, and the per-episode arrays under `episodes`. Each
    episode is scored up to its first termination or truncation, within
    `n_steps` steps (no auto-reset).
    """
    state, obs = env.reset(n_episodes, generator)
    ret = torch.zeros((n_episodes,), dtype=torch.float64, device=env.device)
    length = torch.zeros((n_episodes,), dtype=torch.int32, device=env.device)
    terminated = torch.zeros((n_episodes,), dtype=torch.bool, device=env.device)
    done = torch.zeros_like(terminated)
    for _ in range(n_steps):
        state, obs, reward, term, trunc, _ = env.step(state, policy(obs, generator))
        live = ~done
        ret = ret + torch.where(live, reward.to(torch.float64), 0.0)
        length = length + live.to(torch.int32)
        terminated = terminated | (term & live)
        done = done | term | trunc
        if bool(done.all()):
            break
    returns = ret.cpu().numpy()
    lengths = length.cpu().numpy()
    return {
        "return_mean": float(returns.mean()),
        "return_std": float(returns.std()),
        "length_mean": float(lengths.astype(np.float64).mean()),
        "length_std": float(lengths.astype(np.float64).std()),
        "terminated_frac": float(terminated.cpu().numpy().mean()),
        "episodes": {"return": returns, "length": lengths,
                     "terminated": terminated.cpu().numpy()},
    }
