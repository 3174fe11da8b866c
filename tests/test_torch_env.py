"""The port's `anymal-pid` slice end to end on the CPU at float64: the first
rows of tests/goldens/anymal-pid.csv (zero actions, one env,
tests/golden_configs.py) on the fused rollout path and on the per-period
path.

The goldens come from jiminy_tpu's generic path (on the CPU it never runs its
component core); the port runs its component core on both paths, the same
math reassociated. Measured agreement is about 8e-12 over the first rows; the
tolerance is the repo's golden tolerance, 1e-10. One plain env step costs
about 7 s here (3.1 M eager torch ops), so tier 1 checks three rows per path
and the slow tier all twenty.
"""

import numpy as np
import pytest
import torch

from golden_configs import read_golden
from jiminy_torch.envs import make

ATOL = 1e-10


def _rows(use_fused_rollout: bool, n_rows: int):
    env = make("anymal-pid", device="cpu", dtype=torch.float64)
    env.use_fused_rollout = use_fused_rollout
    st, _ = env.reset()
    action = torch.zeros(env.action_size, dtype=torch.float64)
    rows = []
    for _ in range(n_rows):
        st, _, reward, terminated, _, _ = env.step(st, action)
        sim = st.sim
        rows.append(
            np.concatenate(
                [[float(sim.t)], sim.q.numpy(), sim.v.numpy(), [float(reward)],
                 sim.contact_forces.numpy().ravel()]
            )
        )
        assert not bool(terminated)
    return np.stack(rows)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_period"])
def test_anymal_pid_reproduces_golden_rows(fused):
    golden = read_golden("anymal-pid")
    got = _rows(fused, 3)
    np.testing.assert_allclose(got, golden[:3], atol=ATOL, rtol=0)


@pytest.mark.slow
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_period"])
def test_anymal_pid_reproduces_all_golden_rows(fused):
    golden = read_golden("anymal-pid")
    np.testing.assert_allclose(_rows(fused, len(golden)), golden, atol=ATOL, rtol=0)


def test_anymal_pid_batched_reset_and_observation():
    """Explicitly batched states: B envs in lock-step, reset observation and
    PD command state seeded from the encoders."""
    env = make("anymal-pid", device="cpu", dtype=torch.float64)
    st, obs = env.reset(batch_size=3)
    assert st.sim.q.shape == (3, 19) and st.sim.t.shape == (3,)
    assert obs["measurements"]["encoder"].shape == (3, 12, 2)
    assert obs["measurements"]["imu"].shape == (3, 1, 6)
    assert obs["measurements"]["force"].shape == (3, 4, 6)
    assert obs["targets"]["pd_controller"].shape == (3, 3, 12)
    torch.testing.assert_close(obs["targets"]["pd_controller"][:, 0], st.sim.q[:, 7:])
    # Every env starts from the same auto-levelled pose, feet 1 mm up
    assert torch.equal(st.sim.q[0], st.sim.q[2])
