"""Telemetry (port of `jiminy_tpu.telemetry`): the trajectory containers.
The log, recorder and replay tools wait for ROADMAP.md queue 1 item 14."""

from jiminy_torch.telemetry.trajectory import State, Trajectory

__all__ = ["State", "Trajectory"]
