"""RL training (port of `jiminy_tpu.rl`): PPO with the CAPS and symmetry
regularizers on the batched envs, evaluation and checkpoints. The task
curriculum waits for ROADMAP.md queue 1 item 12."""

from jiminy_torch.rl.checkpoint import restore_checkpoint, save_checkpoint
from jiminy_torch.rl.evaluate import evaluate, evaluate_batch, policy_from_params
from jiminy_torch.rl.ppo import PPOConfig, PPOState, make_train, train

__all__ = [
    "PPOConfig",
    "PPOState",
    "evaluate",
    "evaluate_batch",
    "make_train",
    "policy_from_params",
    "restore_checkpoint",
    "save_checkpoint",
    "train",
]
