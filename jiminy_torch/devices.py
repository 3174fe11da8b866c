"""Device and dtype resolution for the port's entry points.

An entry point runs on the card unless the caller asks for another device.
With no device given and no card present it raises: it never picks the CPU
on its own. The default dtype is float32, the working type on the card.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but no CUDA device is available")
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def resolve_dtype(dtype: Optional[torch.dtype] = None) -> torch.dtype:
    dtype = torch.float32 if dtype is None else dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}; use torch.float32 or torch.float64")
    return dtype
