"""Checkpoint and resume of the port's PPO (ports of tests/test_checkpoint.py):
`train` writes `metrics.jsonl` and the checkpoint files, a restored
checkpoint is the saved state bit for bit (generators' states included),
and a run resumed from a checkpoint lands bit for bit where the straight
run does."""

import json
import os

import pytest
import torch

from jiminy_torch import pytree
from jiminy_torch.envs import make
from jiminy_torch.rl import PPOConfig, make_train, restore_checkpoint, save_checkpoint, train


def _cfg(total_iterations):
    return PPOConfig(n_envs=4, n_steps=8, n_epochs=1, n_minibatches=1,
                     total_iterations=total_iterations)


def _env():
    return make("cartpole", device="cpu", dtype=torch.float64)


def _assert_same(a, b):
    la, lb = pytree.leaves_with_path(a), pytree.leaves_with_path(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()), k
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), k


def test_train_logs_metrics_and_checkpoints(tmp_path):
    log_dir = str(tmp_path / "run")
    state, hist = train(_env(), _cfg(4), generator=torch.Generator().manual_seed(3),
                        log_dir=log_dir, checkpoint_every=2)
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        lines = [json.loads(s) for s in f]
    assert [rec["iteration"] for rec in lines] == [0, 1, 2, 3]
    assert all("episode_return_mean" in rec for rec in lines)
    assert [{k: v for k, v in rec.items() if k != "iteration"} for rec in lines] == hist
    for name in ("ckpt_2", "ckpt_4", "ckpt_final"):
        assert os.path.isfile(os.path.join(log_dir, name)), name

    # The restored final checkpoint is the in-memory state, bit for bit
    restored = restore_checkpoint(os.path.join(log_dir, "ckpt_final"), state)
    _assert_same(restored, state)
    assert restored.generator is not state.generator
    # A target of another shape is refused
    with pytest.raises(ValueError, match="ep_return"):
        restore_checkpoint(os.path.join(log_dir, "ckpt_final"),
                           state.replace(ep_return=state.ep_return[:2]))


def test_resume_is_bit_exact(tmp_path):
    init_fn, train_step = make_train(_env(), _cfg(4))
    state = init_fn(torch.Generator().manual_seed(11))
    for _ in range(2):
        state, _ = train_step(state)
    path = save_checkpoint(str(tmp_path / "ckpt_mid"), state)
    for _ in range(2):
        state, _ = train_step(state)

    # Restored into a fresh init's structure, then 2 more iterations
    resumed = restore_checkpoint(path, init_fn(torch.Generator().manual_seed(0)))
    for _ in range(2):
        resumed, _ = train_step(resumed)
    _assert_same(resumed, state)
    assert int(state.iteration) == 4
