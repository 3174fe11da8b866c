"""PPO of the port (`jiminy_torch.rl`) against jiminy_tpu's on the CPU at
float64.

- `ActorCritic` with the parameters of jiminy_tpu's flax network carried
  across (`convert.actor_critic_from_flax`): mean, log_std and value
  within 1e-12; the port's own initialisation draws flax's distributions.
- The flat observation of cartpole and anymal-pid from jiminy_tpu's reset
  states: within 1e-15 of its scale (gravity's, which the accelerometer
  reads); from jiminy_tpu's own observation tree, bit for bit (the leaf
  order).
- `AutoResetWrapper`: exactly the done envs (truncated and terminated) are
  replaced, by the state `reset_at` gives for the same draws, bit for bit;
  the others are the plain step's, bit for bit.
- One whole `train_step` against jiminy_tpu's `make_train` step on the
  cartpole (4 envs x 8 steps, 2 epochs x 2 minibatches), from jiminy_tpu's
  initial states and parameters, with the same draws: jiminy_tpu's
  `jax.random.normal`, `permutation` and `uniform` (the toys' reset draws)
  are replaced through `monkeypatch` while its step is traced, by numpy
  tables chosen by shape; both draws sit inside scans traced once, so every
  step and epoch sees the same table, and the port is given the same
  tables. The trajectory, the GAE advantages and the rollout's metrics
  are held to 1e-12 of their scale (float64 work on the same values). The
  parameters and Adam moments are stored in float32, as flax stores them,
  and the two programs' float32 arithmetic rounds apart by an ulp here and
  there (XLA contracts multiply-adds, the sums run in other orders), which
  the updates carry on: they are held to PARAM_ULPS (16) float32 ulps of
  their scale (the largest entry; for the first moment the gradients' RMS,
  which it sums), log_std's float64 ones too, since its gradient reads the
  float32 weights. Measured at most 8.8 ulps. The loss metrics average
  minibatches taken after updates at such parameters: held to 16 ulps
  relative (measured at most 7.2e-8).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jiminy_torch import pytree
from jiminy_torch.convert import actor_critic_from_flax
from jiminy_torch.envs import make as t_make
from jiminy_torch.gym import AutoResetWrapper, FlattenObservation, flatten_pytree
from jiminy_torch.rl import networks, ppo
from jiminy_tpu.envs import make as j_make
from jiminy_tpu.gym import FlattenObservation as JFlattenObservation
from jiminy_tpu.gym.wrappers import flatten_pytree as j_flatten_pytree
from jiminy_tpu.rl import PPOConfig as JPPOConfig
from jiminy_tpu.rl import make_train as j_make_train
from jiminy_tpu.rl.networks import ActorCritic as JActorCritic

F64_TOL = 1e-12
OBS_TOL = 1e-15
# The IMU accelerometer reads a - g, computed at gravity's scale: in free
# fall at reset the two programs read 0 and -1.8e-15, one ulp of 9.81
OBS_SCALE = 9.81
PARAM_ULPS = 16
F32_EPS = float(np.finfo(np.float32).eps)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _scaled_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, float(np.abs(b).max())))


# --------------------------------------------------------------------------- #
# Networks
# --------------------------------------------------------------------------- #


def test_actor_critic_matches_flax():
    net = JActorCritic(3, hidden=(32, 16), log_std_init=-0.3)
    params = _np_tree(net.init(jax.random.PRNGKey(0), jnp.zeros((1, 7))))
    sd = actor_critic_from_flax(params)
    module = networks.ActorCritic(7, 3, (32, 16), log_std_init=-0.3, dtype=torch.float64,
                                  device="cpu")
    module.load_state_dict(sd)
    assert module.actor.hidden[0].weight.dtype == torch.float32
    assert module.log_std.dtype == torch.float64 == sd["log_std"].dtype
    obs = np.random.default_rng(1).normal(size=(50, 7))
    ref = net.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        out = module(torch.as_tensor(obs))
    for o, r in zip(out, ref):
        assert o.dtype == torch.float64 and o.shape == r.shape
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), rtol=0, atol=F64_TOL)
    # float32 observations compute in float32, as flax promotes
    mean32, _, value32 = module(torch.as_tensor(obs, dtype=torch.float32))
    assert mean32.dtype == value32.dtype == torch.float32


def test_actor_critic_runs_on_the_card_unless_asked():
    """With no device given the modules go to the card, as every entry point
    of the port does, and never pick the CPU on their own."""
    if torch.cuda.is_available():
        module = networks.ActorCritic(5, 2, (8,))
        assert {p.device.type for p in module.parameters()} == {"cuda"}
    else:
        for build in (lambda: networks.ActorCritic(5, 2, (8,)), lambda: networks.MLP(5, (8, 2))):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build()
    module = networks.ActorCritic(5, 2, (8,), device="cpu")
    assert {p.device.type for p in module.parameters()} == {"cpu"}


def test_actor_critic_initialisation_is_flaxs():
    g = torch.Generator().manual_seed(5)
    module = networks.ActorCritic(40, 6, (64, 48), log_std_init=-0.5, device="cpu", generator=g)
    for mlp in (module.actor, module.critic):
        for layer in mlp.hidden:
            std = np.sqrt(1.0 / layer.in_features) / networks._TRUNC_STD
            w = layer.weight.detach().numpy()
            assert np.abs(w).max() <= 2 * std * (1 + 1e-6)  # truncated at 2 std
            assert abs(w.std() - 0.8796 * std) < 0.1 * std  # the truncated normal's std
            assert not layer.bias.detach().any()
        w = mlp.out.weight.detach().double().numpy()  # (out, in), orthogonal rows x 0.01
        np.testing.assert_allclose(w @ w.T, 1e-4 * np.eye(w.shape[0]), atol=1e-10)
        assert not mlp.out.bias.detach().any()
    assert torch.equal(module.log_std.detach(), torch.full((6,), -0.5))


# --------------------------------------------------------------------------- #
# Observations and the auto-reset
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("env_id", ["cartpole", "anymal-pid"])
def test_flat_observation_matches_jax(env_id):
    j_env = JFlattenObservation(j_make(env_id))
    jst, jobs = j_env.reset(jax.random.PRNGKey(3))
    t_env = FlattenObservation(t_make(env_id, device="cpu", dtype=torch.float64))
    q, v = np.array(jst.sim.q), np.array(jst.sim.v)
    _, tobs = t_env.reset_at(torch.as_tensor(q), torch.as_tensor(v))
    err = np.abs(tobs.numpy() - np.asarray(jobs)).max()
    assert err <= OBS_TOL * max(OBS_SCALE, float(np.abs(np.asarray(jobs)).max()))
    # The leaf order itself: jiminy_tpu's observation tree, flattened here
    tree = _np_tree(j_env.env.observe(jst))
    flat = flatten_pytree(jax.tree.map(torch.as_tensor, tree))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(j_flatten_pytree(tree)))
    # Batched: one row per env, as make_train reads it
    _, bobs = t_env.reset_at(torch.as_tensor(np.stack([q, q])), torch.as_tensor(np.stack([v, v])))
    assert bobs.shape == (2,) + tobs.shape
    np.testing.assert_array_equal(bobs[1].numpy(), tobs.numpy())
    if env_id == "anymal-pid":
        assert sorted(tree) == ["agent_state", "measurements", "t", "targets"]
        assert tobs.shape == (19 + 18 + sum(np.size(x) for x in jax.tree.leaves(
            tree["measurements"])) + 1 + 36,)


def test_auto_reset_replaces_exactly_the_done_envs():
    env = t_make("cartpole", device="cpu", dtype=torch.float64, horizon=3)
    rng = np.random.default_rng(0)
    th = rng.uniform(-0.04, 0.04, size=(6, 2))
    th[0, 0] = 2.5  # beyond the cart's track: terminates
    st, _ = env.reset_at(env.layout.q_of(torch.as_tensor(th)), torch.as_tensor(th * 0.5))
    st = st.replace(steps=torch.tensor([0, 1, 2, 0, 1, 2], dtype=torch.int32))
    action = torch.as_tensor(rng.normal(size=(6, 1)))
    plain = env.step(st, action)
    out = AutoResetWrapper(env).step(st, action, torch.Generator().manual_seed(7))
    draws = env._sample_state((6,), torch.Generator().manual_seed(7))
    fresh_state, fresh_obs = env.reset_at(*draws)
    done = out[5]["done"]
    assert done.tolist() == [True, False, True, False, False, True]
    # The same draws given as the states to reset at: the same step, bit
    # for bit, through the spans in their order
    names = []

    def span(name):
        names.append(name)
        return contextlib.nullcontext()

    given = AutoResetWrapper(env).step(st, action, reset_state=draws, span=span)
    assert names == ["env_step", "reset", "pick"]
    for a, b in zip(pytree.leaves(given[:5]), pytree.leaves(out[:5])):
        assert torch.equal(a, b)
    assert out[3][0] and out[4][2] and out[4][5]  # one termination, two truncations
    for k in (2, 3, 4):  # reward, terminated, truncated are the plain step's
        assert torch.equal(out[k], plain[k])
    for name, (o, p, f) in {
        "obs": (out[1], plain[1], fresh_obs),
        "q": (out[0].sim.q, plain[0].sim.q, fresh_state.sim.q),
        "v": (out[0].sim.v, plain[0].sim.v, fresh_state.sim.v),
        "a": (out[0].sim.a, plain[0].sim.a, fresh_state.sim.a),
        "t": (out[0].sim.t, plain[0].sim.t, fresh_state.sim.t),
        "steps": (out[0].steps, plain[0].steps, fresh_state.steps),
        "last_action": (out[0].last_action, plain[0].last_action, fresh_state.last_action),
        "lam": (out[0].sim.lam, plain[0].sim.lam, fresh_state.sim.lam),
        "contact_forces": (out[0].sim.contact_forces, plain[0].sim.contact_forces,
                           fresh_state.sim.contact_forces),
    }.items():
        assert torch.equal(o[done], f[done]), name
        assert torch.equal(o[~done], p[~done]), name


# --------------------------------------------------------------------------- #
# One train_step against jiminy_tpu's
# --------------------------------------------------------------------------- #

N_ENVS, N_STEPS, N_EPOCHS, N_MB = 4, 8, 2, 2
ROLLOUT_METRICS = ("mean_reward", "mean_done", "episode_return_mean", "episode_length_mean",
                   "episodes")
BASE = dict(n_envs=N_ENVS, n_steps=N_STEPS, n_epochs=N_EPOCHS, n_minibatches=N_MB)
REGULARIZERS = dict(
    caps_temporal_reg=0.1, temporal_barrier_reg=0.05, temporal_barrier_threshold=0.0,
    caps_spatial_reg=0.2, spatial_sgld_steps=2, caps_global_reg=0.05, symmetry_reg=0.1,
    l2_reg=1e-4,
)
CASES = {
    "defaults": (dict(), 500),
    "regularizers": (REGULARIZERS, 500),
    # trips at the second minibatch of the first epoch (its KL ~1e-7)
    "target_kl": (dict(target_kl=1e-8), 500),
    "anneal_lr": (dict(anneal_lr=True, total_iterations=3), 500),
    # every env truncates at its fifth step, inside the rollout
    "truncation": (dict(), 5),
}


def _tables(seed):
    rng = np.random.default_rng(seed)
    mb = N_ENVS * N_STEPS // N_MB
    return {
        "action": rng.normal(size=(N_ENVS, 1)),
        "spatial": rng.normal(size=(mb, 4)),
        "perm": rng.permutation(N_ENVS * N_STEPS),
        "reset": rng.uniform(-0.05, 0.05, size=(2,)),
    }


def _jax_step(monkeypatch, cfg, horizon, tables, symmetry):
    """jiminy_tpu's init (its own draws) and one jitted train_step traced
    with the tables; returns (state before, state after, metrics, traj,
    advantages)."""
    env = j_make("cartpole", horizon=horizon)
    init_fn, train_step = j_make_train(env, cfg, symmetry=symmetry)
    state = init_fn(jax.random.PRNGKey(0))
    normals = {(N_ENVS, 1): tables["action"], tables["spatial"].shape: tables["spatial"]}
    captured = {}
    real = {k: getattr(jax.random, k) for k in ("normal", "permutation", "uniform")}
    real_scan = jax.lax.scan

    def normal(key, shape=(), dtype=float, *a, **kw):
        if tuple(shape) in normals:
            return jnp.asarray(normals[tuple(shape)], dtype)
        return real["normal"](key, shape, dtype, *a, **kw)

    def permutation(key, x, *a, **kw):
        if not hasattr(x, "shape") and x == len(tables["perm"]):
            return jnp.asarray(tables["perm"])
        return real["permutation"](key, x, *a, **kw)

    def uniform(key, shape=(), dtype=float, minval=0.0, maxval=1.0):
        if tuple(shape) == (2,):
            return jnp.asarray(tables["reset"], dtype)
        return real["uniform"](key, shape, dtype, minval, maxval)

    def store(name, x):
        captured[name] = _np_tree(x)

    def scan(f, init, xs=None, length=None, reverse=False, **kw):
        out = real_scan(f, init, xs, length=length, reverse=reverse, **kw)
        name = getattr(f, "__name__", "")
        if name in ("step_once", "scan_fn"):  # the rollout and GAE scans of ppo.py
            jax.debug.callback(functools.partial(store, name), out[1])
        return out

    with monkeypatch.context() as m:
        for name, fn in (("normal", normal), ("permutation", permutation),
                         ("uniform", uniform)):
            m.setattr(jax.random, name, fn)
        m.setattr(jax.lax, "scan", scan)
        new_state, metrics = jax.jit(train_step)(state)
        jax.block_until_ready(metrics)
    return state, new_state, _np_tree(metrics), captured["step_once"], captured["scan_fn"]


def _port_step(cfg, horizon, tables, symmetry, jstate):
    env = t_make("cartpole", device="cpu", dtype=torch.float64, horizon=horizon)
    init_fn, train_step = ppo.make_train(env, cfg, symmetry=symmetry)
    state = init_fn(torch.Generator().manual_seed(0))
    env_state, obs = env.reset_at(torch.as_tensor(np.array(jstate.env_state.sim.q)),
                                  torch.as_tensor(np.array(jstate.env_state.sim.v)))
    state = state.replace(
        params=actor_critic_from_flax(_np_tree(jstate.params)),
        env_state=env_state,
        last_obs=flatten_pytree(obs, 1),
    )
    n_total = N_ENVS * N_STEPS
    reset = torch.as_tensor(tables["reset"]).expand(N_STEPS, N_ENVS, 2)  # the toys' reset draws
    draws = {
        "action": torch.as_tensor(tables["action"]).expand(N_STEPS, N_ENVS, 1),
        "perm": torch.as_tensor(tables["perm"]).expand(N_EPOCHS, n_total),
        "spatial": torch.as_tensor(tables["spatial"]).expand((N_EPOCHS, N_MB)
                                                             + tables["spatial"].shape),
        "reset_q": env.layout.q_of(reset),
        "reset_v": reset,
    }
    record = {}
    new_state, metrics = train_step(state, draws, record)
    return new_state, metrics, record["traj"], record["advantages"]


def _adam(opt_state):
    adam = opt_state[1][0]  # chain(clip, chain(scale_by_adam, scale_by_lr))
    return int(adam.count), actor_critic_from_flax(_np_tree(adam.mu)), actor_critic_from_flax(
        _np_tree(adam.nu))


def _assert_close(name, out, ref, scale):
    """Within PARAM_ULPS float32 ulps of `scale` (log_std's float64 leaves
    too: its gradient reads the float32 weights)."""
    err = float((out.double() - ref.double()).abs().max())
    assert out.dtype == ref.dtype, name
    assert err <= PARAM_ULPS * F32_EPS * scale, (name, err / scale)


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(monkeypatch, case):
    overrides, horizon = CASES[case]
    symmetry = (lambda o: -o, lambda a: -a) if case == "regularizers" else None
    tables = _tables(seed=sorted(CASES).index(case))
    jcfg = JPPOConfig(**BASE, **overrides)
    tcfg = ppo.PPOConfig(**BASE, **overrides)
    jstate, jnew, jmetrics, jtraj, jadv = _jax_step(monkeypatch, jcfg, horizon, tables, symmetry)
    tnew, tmetrics, ttraj, tadv = _port_step(tcfg, horizon, tables, symmetry, jstate)

    # The trajectory, exact where it is discrete
    for k in ("done", "ep_length_final"):
        np.testing.assert_array_equal(ttraj[k].numpy(), jtraj[k], err_msg=k)
    for k in ("obs", "action", "logp", "value", "reward", "ep_return_final"):
        assert _scaled_err(ttraj[k].numpy(), jtraj[k]) <= F64_TOL, k
    assert _scaled_err(tadv.numpy(), jadv) <= F64_TOL
    if case == "truncation":
        assert jtraj["done"][4].all() and not jtraj["done"][:4].any()
        np.testing.assert_array_equal(jtraj["ep_length_final"][4], 5)
    else:
        assert not jtraj["done"].any()

    # The rollout's metrics are float64 work on the same values; the loss
    # metrics average minibatches taken after updates, at parameters that
    # agree to PARAM_ULPS float32 ulps
    assert set(tmetrics) == set(jmetrics)
    for k, v in jmetrics.items():
        if k in ROLLOUT_METRICS:
            assert _scaled_err(float(tmetrics[k]), v) <= F64_TOL, k
        else:
            assert abs(float(tmetrics[k]) - float(v)) <= PARAM_ULPS * F32_EPS * abs(float(v)), k

    jparams = actor_critic_from_flax(_np_tree(jnew.params))
    count, mu, nu = _adam(jnew.opt_state)
    assert int(tnew.opt_state["count"]) == count
    assert count == (1 if case == "target_kl" else N_EPOCHS * N_MB)
    for k in jparams:
        # mu is a running sum of gradients, held at their RMS (sqrt of the
        # bias-corrected nu); the others at their largest entry
        rms = float((nu[k].double().max() / (1 - 0.999**count)).sqrt())
        _assert_close(k, tnew.params[k], jparams[k], float(jparams[k].abs().max()))
        _assert_close(f"mu/{k}", tnew.opt_state["mu"][k], mu[k], rms)
        _assert_close(f"nu/{k}", tnew.opt_state["nu"][k], nu[k], float(nu[k].abs().max()))
    if case == "anneal_lr":
        assert int(jnew.opt_state[1][1].count) == count
    # The carried env states and episode accumulators
    assert _scaled_err(tnew.env_state.sim.q.numpy(), np.asarray(jnew.env_state.sim.q)) <= F64_TOL
    assert _scaled_err(tnew.ep_return.numpy(), np.asarray(jnew.ep_return)) <= F64_TOL
    np.testing.assert_array_equal(tnew.ep_length.numpy(), np.asarray(jnew.ep_length))
    assert int(tnew.iteration) == int(jnew.iteration) == 1


def test_train_step_record_and_spans():
    """`record` receives the iteration's trajectory, advantages and returns;
    `span` is entered around the iteration's pieces and each rollout step's,
    in their order."""
    env = t_make("cartpole", device="cpu", dtype=torch.float64)
    names = []

    def span(name):
        names.append(name)
        return contextlib.nullcontext()

    cfg = ppo.PPOConfig(n_envs=3, n_steps=2, n_epochs=1, n_minibatches=2)
    init_fn, train_step = ppo.make_train(env, cfg, span=span)
    state = init_fn(torch.Generator().manual_seed(0))
    record = {}
    _, metrics = train_step(state, record=record)
    step = ["policy", "env_step", "reset", "pick"]
    assert names == ["rollout"] + step * 2 + ["gae", "update"]
    assert record["traj"]["obs"].shape == (2, 3, 4)
    assert record["advantages"].shape == record["returns"].shape == (2, 3)
    torch.testing.assert_close(record["returns"] - record["advantages"], record["traj"]["value"],
                               rtol=0, atol=1e-12)
    # Without the hooks, the same step
    _, plain = ppo.make_train(env, cfg)[1](state)
    for k, v in metrics.items():
        assert torch.equal(v, plain[k]), k
