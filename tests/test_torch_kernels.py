"""Card-only tests: each cdyn CUDA kernel held against its plain PyTorch
version on the card, at a small batch, for the ANYmal constants.

Marked `cuda`; they skip where no CUDA device is present (the check runs in a
fixture, never at import). On a machine with a card, run them with:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

(`--noconftest` because the repo's conftest configures JAX, which the port
neither needs nor finds on the card's machine.)

Tolerances, per output column, so that a small output is not hidden
behind a large one:
- float64: max over envs |kernel - plain| / (1 + max over envs |plain|)
  below 1e-9. Both sides run the same IEEE operations in the same order; the
  kernel differs by FMA contraction only.
- float32: the 90th percentile over envs of |kernel - plain| / RMS of the
  column below 2e-3 for one evaluation, 1e-2 for integrated periods and
  steps. FMA contraction changes the last bit of many products, and the
  stiff contact and penalty-bound springs amplify such differences in the
  odd env over a step; a zeroed column, or one wrong in a tenth of the envs,
  still fails.
"""

import pytest
import torch

from jiminy_torch.envs import make
from jiminy_torch.ops import cdyn
from jiminy_torch.testing import column_errors, column_quantile_errors, perturbed_states

TOL = {torch.float64: (1e-9, 1e-9), torch.float32: (2e-3, 1e-2)}


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _env(device, dtype):
    return make("anymal-pid", device=device, dtype=dtype)


def _error(out, ref, dtype) -> float:
    fn = column_errors if dtype == torch.float64 else column_quantile_errors
    return float(fn(out, ref).max())


@pytest.mark.cuda
def test_kernel_library_builds(cuda_device):
    from jiminy_torch.ops import kernels

    lib = kernels.load()
    assert lib.caps["nj"] >= 13
    for name in ("cdyn_accel", "cdyn_period", "cdyn_rollout"):
        assert name in lib.build.ptxas_log


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_accel_kernel_matches_plain(cuda_device, dtype):
    env = _env(cuda_device, dtype)
    cd = env.engine._cdyn
    q, v, tau = perturbed_states(env, 512, seed=0)
    out = cd.accel_kernel(q, v, tau)
    ref = cd.accel_plain(q, v, tau)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _error(out, ref, dtype) < TOL[dtype][0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_period_kernel_matches_plain(cuda_device, dtype):
    env = _env(cuda_device, dtype)
    run = env.engine._get_period_run("rk4")
    q, v, _ = perturbed_states(env, 64, seed=1)
    cmd = torch.randn((64, env.robot.nmotors), dtype=dtype, device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(1)) * 20.0
    outs = run.kernel(q, v, cmd, n_substeps=2)
    refs = run.plain(q, v, cmd, n_substeps=2)
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        assert torch.isfinite(out).all()
        assert _error(out, ref, dtype) < TOL[dtype][1]


@pytest.mark.cuda
@pytest.mark.parametrize("controller", ["pd", "zoh"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rollout_kernel_matches_plain(cuda_device, dtype, controller):
    env = _env(cuda_device, dtype)
    base = env.env
    nm = env.robot.nmotors
    q, v, _ = perturbed_states(env, 64, seed=2)
    gen = torch.Generator(cuda_device).manual_seed(2)
    if controller == "pd":
        ctrl = env.block.component_controller(base)
        action = torch.randn((64, nm), dtype=dtype, device=cuda_device, generator=gen) * 50.0
        carry = torch.zeros((64, 3 * nm), dtype=dtype, device=cuda_device)
        carry[:, :nm] = q[:, 7:]
    else:
        ctrl = cdyn.ZOHPassThrough(nm)
        action = torch.randn((64, nm), dtype=dtype, device=cuda_device, generator=gen) * 20.0
        carry = torch.zeros((64, 0), dtype=dtype, device=cuda_device)
    run = base.engine._get_rollout_run("test-" + controller, ctrl, 8)
    outs = run.kernel(q, v, action, carry, n_ticks=2, n_substeps=1)
    refs = run.plain(q, v, action, carry, n_ticks=2, n_substeps=1)
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        assert torch.isfinite(out).all()
        assert _error(out, ref, dtype) < TOL[dtype][1]


@pytest.mark.cuda
def test_wrappers_route_cuda_tensors_to_kernels(cuda_device):
    env = _env(cuda_device, torch.float64)
    cdyn.reset_launch_counts()
    st, _ = env.reset(batch_size=3)
    st, *_ = env.step(st, torch.zeros(12, dtype=torch.float64, device=cuda_device))
    torch.cuda.synchronize()
    assert cdyn.KERNELS["cdyn_accel"].launches == 1
    assert cdyn.KERNELS["cdyn_rollout"].launches == 1
    assert torch.isfinite(st.sim.q).all()
