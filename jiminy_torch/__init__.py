"""jiminy_torch: the PyTorch/CUDA port of jiminy_tpu.

The port runs on one NVIDIA GPU. Plain tensor code is PyTorch; the three
component-dynamics kernels (`ops/cdyn.py`) are hand-written CUDA C++ in
`csrc/cdyn.cu`, built with nvcc at first use. Entry points run on the card
unless the caller passes ``device="cpu"``, where every kernel wrapper takes
its plain PyTorch version instead.
"""

from jiminy_torch.devices import resolve_device, resolve_dtype

__all__ = ["resolve_device", "resolve_dtype"]
