"""PPO on batched rollouts of the port's envs (port of `jiminy_tpu.rl.ppo`).

Clipped-surrogate PPO with the reference's regularizers (reference
`rllib/ppo.py:207-325`): CAPS temporal smoothness E|pi(s_t) - pi(s_{t+1})|,
the temporal barrier, CAPS spatial smoothness E||pi(s) - pi(s + eps)||^2 with
optional SGLD refinement of eps, the CAPS global term E||pi(s)||^2, the
policy symmetry surrogate and L2 weight decay.

`make_train(env, config) -> (init_fn, train_step)`: `init_fn(generator)`
gives a `PPOState`, `train_step(state, draws=None)` one iteration, the
rollout of the batched env with auto-reset, GAE and epochs of minibatched
Adam updates. The rollout, `compute_gae` and `update` are plain functions
of tensors. Every random draw of an iteration is an explicit argument of
them: the action noise, the epochs' permutations and the spatial noise,
drawn from `state.generator` unless `train_step` is given `draws`; the
auto-reset draws its initial states with `state.reset_generator` unless the
draws hold them too. Neither generator of the given state is advanced: the
new state holds advanced copies, so `train_step` is a function of its state.

Observing an iteration needs no patching: `train_step(state, draws,
record)` stores the trajectory and the GAE advantages and returns in the
dict `record`, and `make_train(..., span=)` takes a factory of context
managers, `span(name)`, entered around the iteration's pieces ("rollout",
"gae", "update") and each rollout step's ("policy", then the auto-reset
env's "env_step", "reset" and "pick"); a profiler or CUDA events hang
there.

The numerics are optax's and jiminy_tpu's: advantages normalised by the
population std, gradients clipped by their global norm only past
`max_grad_norm`, Adam with optax's defaults and its linear schedule counted
in applied updates, the `target_kl` stop applied before the minibatch that
trips it (a stopped update advances neither Adam nor the schedule), and GAE
cut at truncations as at terminations.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Callable, Dict, Optional

import torch

from jiminy_torch.gym.base import AutoResetWrapper, no_span
from jiminy_torch.gym.wrappers import flatten_pytree
from jiminy_torch.rl import networks

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    n_envs: int = 64
    n_steps: int = 64          # rollout length per env per iteration
    n_epochs: int = 4
    n_minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    # Early-stop updates once approx KL exceeds 1.5x this (None/0 = off)
    target_kl: Optional[float] = None
    lr: float = 3.0e-4
    max_grad_norm: float = 0.5
    anneal_lr: bool = False
    total_iterations: int = 100
    hidden: tuple = (256, 256)
    log_std_init: float = -0.5
    # Regularizers (reference rllib/ppo.py)
    caps_temporal_reg: float = 0.0
    caps_spatial_reg: float = 0.0
    caps_global_reg: float = 0.0
    spatial_noise_std: float = 0.1
    temporal_barrier_reg: float = 0.0
    temporal_barrier_scale: float = 10.0
    temporal_barrier_threshold: float = float("inf")
    spatial_sgld_steps: int = 0
    l2_reg: float = 0.0
    # jiminy_tpu's "vmap" or "batched" env stepping; the port steps its
    # explicitly batched envs either way (both compute the same thing)
    vectorization: str = "vmap"
    # Weight of E||pi(mirror_obs(s)) - mirror_act(pi(s))||^2; the mirror
    # functions are given to make_train
    symmetry_reg: float = 0.0


@dataclasses.dataclass
class PPOState:
    params: Dict[str, torch.Tensor]  # named as `networks.ActorCritic`'s
    opt_state: Dict[str, Any]  # Adam: "count" (int32), "mu" and "nu" per parameter
    env_state: Any  # batched EnvState
    last_obs: torch.Tensor  # (n_envs, obs_dim)
    generator: torch.Generator  # action noise, permutations, spatial noise
    reset_generator: torch.Generator  # the auto-reset's initial states
    iteration: torch.Tensor  # int32
    # Per-env episode accumulators (reference `MonitorEpisodeCallback`),
    # carried across rollout boundaries
    ep_return: torch.Tensor  # (n_envs,)
    ep_length: torch.Tensor  # (n_envs,) int32

    def replace(self, **kw) -> "PPOState":
        return dataclasses.replace(self, **kw)


def _fork(generator: torch.Generator) -> torch.Generator:
    """A new generator in `generator`'s state."""
    g = torch.Generator(generator.device)
    g.set_state(generator.get_state())
    return g


def _gaussian_logp(mean, log_std, action):
    var = torch.exp(2 * log_std)
    return torch.sum(
        -0.5 * ((action - mean) ** 2 / var + 2 * log_std + math.log(2 * math.pi)), dim=-1
    )


def _gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1)


# --------------------------------------------------------------------------- #
# The iteration's pieces
# --------------------------------------------------------------------------- #


def rollout(env, params, env_state, obs, ep_return, ep_length, action_noise, generator,
            reset_draws=None, span=no_span):
    """`action_noise.shape[0]` steps of the auto-reset env under the policy,
    action noise given (n_steps, B, act_dim); the auto-reset's initial
    states drawn with `generator`, or given as `reset_draws`, a pair (q0,
    v0) of (n_steps, B, nq) and (n_steps, B, nv). Returns (env_state,
    last_obs, ep_return, ep_length, traj) with traj's entries stacked
    (n_steps, B, ...)."""
    steps = []
    for t, noise in enumerate(action_noise):
        with span("policy"):
            mean, log_std, value = networks.apply(params, obs)
            action = mean + torch.exp(log_std) * noise
            logp = _gaussian_logp(mean, log_std, action)
        fresh = None if reset_draws is None else (reset_draws[0][t], reset_draws[1][t])
        env_state, next_obs, reward, term, trunc, _ = env.step(env_state, action, generator,
                                                               fresh, span)
        next_obs = flatten_pytree(next_obs, 1)
        done = term | trunc
        ep_return = ep_return + reward
        ep_length = ep_length + 1
        steps.append({
            "obs": obs, "action": action, "logp": logp, "value": value, "reward": reward,
            "done": done,
            # Finished-episode stats, nonzero only where an episode ends
            "ep_return_final": torch.where(done, ep_return, 0.0),
            "ep_length_final": torch.where(done, ep_length, 0),
        })
        ep_return = torch.where(done, 0.0, ep_return)
        ep_length = torch.where(done, 0, ep_length)
        obs = next_obs
    traj = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
    return env_state, obs, ep_return, ep_length, traj


def compute_gae(traj, last_value, gamma: float, gae_lambda: float):
    """(advantages, returns), (n_steps, B); a truncation cuts the trace as a
    termination does."""
    gae, next_value = torch.zeros_like(last_value), last_value
    advantages = [None] * traj["reward"].shape[0]
    for t in reversed(range(len(advantages))):
        value = traj["value"][t]
        nonterminal = 1.0 - traj["done"][t].to(value.dtype)
        delta = traj["reward"][t] + gamma * next_value * nonterminal - value
        gae = delta + gamma * gae_lambda * nonterminal * gae
        advantages[t], next_value = gae, value
    advantages = torch.stack(advantages)
    return advantages, advantages + traj["value"]


def loss_fn(params, batch, spatial_noise, config: PPOConfig, symmetry=None):
    """(total loss, metrics) of one minibatch; `spatial_noise` is a standard
    normal table of the observations' shape (None without the spatial term)."""
    mean, log_std, value = networks.apply(params, batch["obs"])
    logp = _gaussian_logp(mean, log_std, batch["action"])
    ratio = torch.exp(logp - batch["logp"])
    adv = batch["advantage"]
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - config.clip_eps, 1 + config.clip_eps) * adv
    pg_loss = -torch.mean(torch.minimum(unclipped, clipped))
    v_clipped = batch["value"] + torch.clamp(value - batch["value"], -config.clip_eps,
                                             config.clip_eps)
    vf_loss = 0.5 * torch.mean(torch.maximum((value - batch["return"]) ** 2,
                                             (v_clipped - batch["return"]) ** 2))
    ent = torch.mean(_gaussian_entropy(log_std))
    total = pg_loss + config.vf_coef * vf_loss - config.ent_coef * ent

    if config.caps_temporal_reg > 0.0 or config.temporal_barrier_reg > 0.0:
        mean_next, _, _ = networks.apply(params, batch["next_obs"])
        action_delta = torch.abs(mean_next - mean)
        if config.caps_temporal_reg > 0.0:
            total = total + config.caps_temporal_reg * torch.mean(action_delta)
        if config.temporal_barrier_reg > 0.0:
            barrier = torch.exp(torch.clamp(
                config.temporal_barrier_scale
                * (action_delta - config.temporal_barrier_threshold), 0.0, 5.0)) - 1.0
            total = total + config.temporal_barrier_reg * torch.mean(barrier)
    if config.caps_spatial_reg > 0.0:
        std = config.spatial_noise_std
        noise = std * spatial_noise
        if config.spatial_sgld_steps > 0:
            # Signed-gradient ascent on the policy change, a constant of the
            # parameters (no gradient reaches them through the sign)
            step_size = std / max(config.spatial_sgld_steps, 1)
            frozen = {k: p.detach() for k, p in params.items()}
            mean0 = mean.detach()
            with torch.enable_grad():
                for _ in range(config.spatial_sgld_steps):
                    n = noise.detach().requires_grad_(True)
                    m, _, _ = networks.apply(frozen, batch["obs"] + n)
                    (g,) = torch.autograd.grad(torch.sum((mean0 - m) ** 2), n)
                    noise = torch.clamp(noise + step_size * torch.sign(g), -2 * std, 2 * std)
        mean_noisy, _, _ = networks.apply(params, batch["obs"] + noise.detach())
        total = total + config.caps_spatial_reg * torch.mean(
            torch.sum((mean - mean_noisy) ** 2, dim=-1))
    if config.caps_global_reg > 0.0:
        total = total + config.caps_global_reg * torch.mean(torch.sum(mean**2, dim=-1))
    if config.symmetry_reg > 0.0 and symmetry is not None:
        mirror_obs, mirror_act = symmetry
        mean_mirror, _, _ = networks.apply(params, mirror_obs(batch["obs"]))
        total = total + config.symmetry_reg * torch.mean(
            torch.sum((mean_mirror - mirror_act(mean)) ** 2, dim=-1))
    if config.l2_reg > 0.0:
        l2 = sum(torch.sum(params[k] ** 2) for k in sorted(params) if params[k].ndim >= 2)
        total = total + config.l2_reg * l2
    metrics = {
        "loss": total,
        "pg_loss": pg_loss,
        "vf_loss": vf_loss,
        "entropy": ent,
        "approx_kl": torch.mean(batch["logp"] - logp),
        # Nonnegative estimator E[(r - 1) - log r]
        "approx_kl_pos": torch.mean((ratio - 1.0) - torch.log(ratio)),
    }
    return total, metrics


def adam_init(params) -> Dict[str, Any]:
    device = next(iter(params.values())).device
    return {
        "count": torch.zeros((), dtype=torch.int32, device=device),
        "mu": {k: torch.zeros_like(p) for k, p in params.items()},
        "nu": {k: torch.zeros_like(p) for k, p in params.items()},
    }


def _learning_rate(config: PPOConfig, count):
    """The step's learning rate: optax's constant, or its float32
    `linear_schedule` over every update of the run at `count` updates."""
    if not config.anneal_lr:
        return config.lr
    steps = config.total_iterations * config.n_epochs * config.n_minibatches
    frac = 1 - torch.clamp(count, 0, steps).to(torch.float32) / float(steps)
    return config.lr * frac


@torch.no_grad()
def apply_update(config: PPOConfig, params, opt_state, grads, stop):
    """optax's chain(clip_by_global_norm, adam) step, kept only where `stop`
    is false (a stopped update advances neither the moments nor the count)."""
    names = sorted(grads)  # optax's leaf order: the global norm's sum order
    sq = None
    for k in names:
        s = torch.sum(grads[k] * grads[k])
        sq = s if sq is None else sq + s
    norm = torch.sqrt(sq)
    clip = norm < config.max_grad_norm
    count = opt_state["count"] + 1
    bc1 = 1 - ADAM_B1 ** count.to(torch.float64)
    bc2 = 1 - ADAM_B2 ** count.to(torch.float64)
    lr = _learning_rate(config, opt_state["count"])
    new_p, mu, nu = {}, {}, {}
    for k in names:
        g = grads[k]
        g = torch.where(clip, g, (g / norm.to(g.dtype)) * config.max_grad_norm)
        m = (1 - ADAM_B1) * g + ADAM_B1 * opt_state["mu"][k]
        v = (1 - ADAM_B2) * g**2 + ADAM_B2 * opt_state["nu"][k]
        u = (m / bc1.to(g.dtype)) / (torch.sqrt(v / bc2.to(g.dtype)) + ADAM_EPS)
        lr_k = lr if isinstance(lr, float) else lr.to(g.dtype)
        new_p[k] = torch.where(stop, params[k], (params[k] - lr_k * u).to(params[k].dtype))
        mu[k] = torch.where(stop, opt_state["mu"][k], m)
        nu[k] = torch.where(stop, opt_state["nu"][k], v)
    count = torch.where(stop, opt_state["count"], count)
    return new_p, {"count": count, "mu": mu, "nu": nu}


def update(config: PPOConfig, params, opt_state, flat, perms, spatial_noise, symmetry=None):
    """The epochs of minibatched updates on the flattened (T*B, ...) batch;
    `perms` (n_epochs, T*B) are the epochs' permutations, `spatial_noise`
    (n_epochs, n_minibatches, mb, obs_dim) or None. Returns (params,
    opt_state, metrics averaged over every minibatch)."""
    n_total = flat["obs"].shape[0]
    mb_size = n_total // config.n_minibatches
    stop = torch.zeros((), dtype=torch.bool, device=flat["obs"].device)
    history = []
    for epoch, perm in enumerate(perms):
        shuffled = {k: x[perm] for k, x in flat.items()}
        for i in range(config.n_minibatches):
            mb = {k: x[i * mb_size:(i + 1) * mb_size] for k, x in shuffled.items()}
            p = {k: x.detach().requires_grad_(True) for k, x in params.items()}
            noise = None if spatial_noise is None else spatial_noise[epoch, i]
            total, metrics = loss_fn(p, mb, noise, config, symmetry)
            names = sorted(p)
            grads = dict(zip(names, torch.autograd.grad(total, [p[k] for k in names])))
            metrics = {k: x.detach() for k, x in metrics.items()}
            if config.target_kl is not None and config.target_kl > 0:
                # Checked before this minibatch's update is applied
                stop = stop | (metrics["approx_kl_pos"] > 1.5 * config.target_kl)
            params, opt_state = apply_update(config, params, opt_state, grads, stop)
            history.append(metrics)
    return params, opt_state, {k: torch.stack([m[k] for m in history]).mean()
                               for k in history[0]}


# --------------------------------------------------------------------------- #
# make_train / train
# --------------------------------------------------------------------------- #


def make_train(env, config: PPOConfig, mesh=None, symmetry: Optional[tuple] = None,
               curriculum=None, span: Callable = no_span):
    """Returns (init_fn, train_step).

    `env` is batched and auto-reset here; its observations are flattened
    with their leaves in `jax.tree.leaves` order (wrap it with
    `FlattenObservation` to fix the layout). `symmetry`: an optional
    (mirror_obs_fn, mirror_act_fn) pair for the symmetry surrogate.
    `init_fn(generator) -> PPOState`; `train_step(state, draws=None,
    record=None) -> (state, metrics)`, with `draws` an optional dict of the
    iteration's tables: "action" (n_steps, n_envs, act_dim) standard normal,
    "perm" (n_epochs, n_steps * n_envs) permutations, with the spatial term
    "spatial" (n_epochs, n_minibatches, mb, obs_dim) standard normal and,
    optionally, the auto-reset's initial states "reset_q" (n_steps, n_envs,
    nq) and "reset_v" (n_steps, n_envs, nv). A dict `record` receives the
    iteration's "traj", "advantages" and "returns". `span(name)`: see the
    module's docstring.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (sharded training) is not ported yet (ROADMAP.md queue 1 item 15)"
        )
    if curriculum is not None:
        raise NotImplementedError(
            "curriculum= needs toolbox/meta_envs.TaskSettableWrapper, not ported yet "
            "(ROADMAP.md queue 1 item 12)"
        )
    if config.vectorization not in ("vmap", "batched"):
        raise ValueError(f"unknown vectorization {config.vectorization!r}")
    env = AutoResetWrapper(env)
    n_total = config.n_steps * config.n_envs

    def init_fn(generator: torch.Generator) -> PPOState:
        g = _fork(generator)
        s_reset, s_net, s_ppo = torch.randint(0, 2**62, (3,), generator=g,
                                              device=g.device).tolist()
        reset_gen = torch.Generator(env.device).manual_seed(s_reset)
        env_state, obs = env.reset(config.n_envs, reset_gen)
        obs = flatten_pytree(obs, 1)
        # Drawn on the CPU, so the initial parameters are the same on every device
        network = networks.ActorCritic(
            obs.shape[-1], env.action_size, config.hidden, log_std_init=config.log_std_init,
            dtype=env.dtype, device="cpu", generator=torch.Generator().manual_seed(s_net),
        )
        params = {k: p.detach().to(env.device) for k, p in network.named_parameters()}
        return PPOState(
            params=params,
            opt_state=adam_init(params),
            env_state=env_state,
            last_obs=obs,
            generator=torch.Generator(env.device).manual_seed(s_ppo),
            reset_generator=reset_gen,
            iteration=torch.zeros((), dtype=torch.int32, device=env.device),
            ep_return=torch.zeros((config.n_envs,), dtype=obs.dtype, device=env.device),
            ep_length=torch.zeros((config.n_envs,), dtype=torch.int32, device=env.device),
        )

    def sample_draws(g: torch.Generator, obs: torch.Tensor) -> Dict[str, torch.Tensor]:
        kw = dict(generator=g, device=obs.device, dtype=obs.dtype)
        draws = {
            "action": torch.randn((config.n_steps, config.n_envs, env.action_size), **kw),
            "perm": torch.stack([torch.randperm(n_total, generator=g, device=obs.device)
                                 for _ in range(config.n_epochs)]),
        }
        if config.caps_spatial_reg > 0.0:
            draws["spatial"] = torch.randn(
                (config.n_epochs, config.n_minibatches, n_total // config.n_minibatches,
                 obs.shape[-1]), **kw)
        return draws

    def train_step(state: PPOState, draws: Optional[Dict[str, torch.Tensor]] = None,
                   record: Optional[Dict[str, Any]] = None):
        generator = state.generator
        if draws is None:
            generator = _fork(generator)
            draws = sample_draws(generator, state.last_obs)
        reset_gen = _fork(state.reset_generator)
        reset_draws = (draws["reset_q"], draws["reset_v"]) if "reset_q" in draws else None
        with torch.no_grad():
            with span("rollout"):
                env_state, last_obs, ep_ret, ep_len, traj = rollout(
                    env, state.params, state.env_state, state.last_obs, state.ep_return,
                    state.ep_length, draws["action"], reset_gen, reset_draws, span)
            with span("gae"):
                _, _, last_value = networks.apply(state.params, last_obs)
                advantages, returns = compute_gae(traj, last_value, config.gamma,
                                                  config.gae_lambda)
        if record is not None:
            record.update(traj=traj, advantages=advantages, returns=returns)
        batch = {
            "obs": traj["obs"],
            "next_obs": torch.cat([traj["obs"][1:], last_obs[None]], dim=0),
            "action": traj["action"],
            "logp": traj["logp"],
            "value": traj["value"],
            "advantage": advantages,
            "return": returns,
        }
        flat = {k: x.reshape((-1,) + x.shape[2:]) for k, x in batch.items()}
        with span("update"):
            params, opt_state, metrics = update(config, state.params, state.opt_state, flat,
                                                draws["perm"], draws.get("spatial"), symmetry)
        done = traj["done"].to(torch.float32)
        n_done = torch.sum(done)
        denom = torch.clamp(n_done, min=1.0)
        ep_metrics = {
            "mean_reward": torch.mean(traj["reward"]),
            "mean_done": torch.mean(done),
            "episode_return_mean": torch.sum(traj["ep_return_final"]) / denom,
            "episode_length_mean": torch.sum(traj["ep_length_final"].to(torch.float32)) / denom,
            "episodes": n_done,
            **metrics,
        }
        return PPOState(
            params=params,
            opt_state=opt_state,
            env_state=env_state,
            last_obs=last_obs,
            generator=generator,
            reset_generator=reset_gen,
            iteration=state.iteration + 1,
            ep_return=ep_ret,
            ep_length=ep_len,
        ), ep_metrics

    return init_fn, train_step


def train(
    env,
    config: PPOConfig,
    generator: Optional[torch.Generator] = None,
    mesh=None,
    callback: Optional[Callable] = None,
    symmetry: Optional[tuple] = None,
    curriculum=None,
    log_dir: Optional[str] = None,
    checkpoint_every: int = 0,
):
    """Run `config.total_iterations` PPO iterations on the env's device;
    returns (state, history).

    `generator` (None: one seeded 0 on the env's device) seeds the run. With
    `log_dir`, each iteration's metrics are appended to
    `<log_dir>/metrics.jsonl` as one JSON line and, when `checkpoint_every >
    0`, the whole `PPOState` (parameters, Adam state, env states, episode
    accumulators, generators' states: a bit-exact resume) is saved every
    that many iterations to `<log_dir>/ckpt_<i>` and at the end to
    `<log_dir>/ckpt_final`. `callback(i, state, metrics)` runs after each
    iteration.
    """
    from jiminy_torch.rl.checkpoint import save_checkpoint

    init_fn, train_step = make_train(env, config, mesh=mesh, symmetry=symmetry,
                                     curriculum=curriculum)
    if generator is None:
        generator = torch.Generator(env.device).manual_seed(0)
    state = init_fn(generator)
    metrics_file = None
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        metrics_file = open(os.path.join(log_dir, "metrics.jsonl"), "a")  # noqa: SIM115
    history = []
    try:
        for i in range(config.total_iterations):
            state, metrics = train_step(state)
            metrics = {k: float(v) if v.ndim == 0 else v.tolist() for k, v in metrics.items()}
            history.append(metrics)
            if metrics_file is not None:
                metrics_file.write(json.dumps({"iteration": i, **metrics}) + "\n")
                metrics_file.flush()
            if log_dir is not None and checkpoint_every > 0 and (i + 1) % checkpoint_every == 0:
                save_checkpoint(os.path.join(log_dir, f"ckpt_{i + 1}"), state)
            if callback is not None:
                callback(i, state, metrics)
        if log_dir is not None and checkpoint_every > 0:
            save_checkpoint(os.path.join(log_dir, "ckpt_final"), state)
    finally:
        if metrics_file is not None:
            metrics_file.close()
    return state, history
