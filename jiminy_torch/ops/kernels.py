"""Build and bind the port's CUDA kernels (`csrc/*.cu`).

Each source is compiled by nvcc for sm_90a into a shared library with a plain
C interface, at first use, into `build/jiminy_torch/` beside the package
(listed in `.gitignore`), and bound with ctypes. The library file name
carries a hash of the source and the flags, so an edit rebuilds and an
unchanged tree reuses the build. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "jiminy_torch"
SOURCE = CSRC_DIR / "cdyn.cu"
HEADERS = (CSRC_DIR / "cdyn.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CAP_NAMES = ("nj", "nq", "nv", "nc", "ni", "nm", "nb", "n_cmd", "n_action", "n_carry")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "cdyn_accel": [_P, _P, _P, _P, _P, _P, _I, _P],
    "cdyn_period": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cdyn_rollout": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _I, _P],
}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


@dataclasses.dataclass
class BuildResult:
    path: Path
    ptxas_log: str  # nvcc -Xptxas -v output: registers, spills, stack per kernel
    seconds: float  # build time (0 when reused)
    reused: bool


def build(source: Path = SOURCE) -> BuildResult:
    """Compile `source` unless a build of the same source and flags exists."""
    digest = hashlib.sha256()
    for p in (source, *HEADERS):
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    key = digest.hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"lib{source.stem}_{key}.so"
    log = lib.with_suffix(".ptxas.txt")
    if lib.exists() and log.exists():
        return BuildResult(lib, log.read_text(), 0.0, True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), str(source)],
        capture_output=True,
        text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}\n{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return BuildResult(lib, log.read_text(), seconds, False)


class Library:
    """The bound kernel library: `entry(name, dtype)` and the compiled caps."""

    def __init__(self, result: BuildResult):
        self.build = result
        self._dll = ctypes.CDLL(str(result.path))
        self._entries = {}
        for name, argtypes in _SIGNATURES.items():
            for suffix, dtype in (("f32", torch.float32), ("f64", torch.float64)):
                fn = getattr(self._dll, f"{name}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                self._entries[(name, dtype)] = fn
        caps_fn = self._dll.cdyn_caps
        caps_fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        caps_fn.restype = ctypes.c_int
        buf = (ctypes.c_int * len(CAP_NAMES))()
        n = caps_fn(buf, len(CAP_NAMES))
        if n != len(CAP_NAMES):
            raise RuntimeError(f"cdyn_caps returned {n} caps, expected {len(CAP_NAMES)}")
        self.caps = dict(zip(CAP_NAMES, list(buf)))
        self._err = self._dll.cdyn_error_string
        self._err.argtypes = [ctypes.c_int]
        self._err.restype = ctypes.c_char_p

    def entry(self, name: str, dtype):
        try:
            return self._entries[(name, dtype)]
        except KeyError:
            raise ValueError(f"no kernel {name} for dtype {dtype}") from None

    def error_string(self, code: int) -> str:
        return self._err(int(code)).decode()


_LIBRARY: Optional[Library] = None


def load() -> Library:
    """Build (if needed) and bind the kernels once per process."""
    global _LIBRARY
    if _LIBRARY is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the cdyn kernels need a CUDA device")
        _LIBRARY = Library(build())
    return _LIBRARY


def error_string(code: int) -> str:
    return load().error_string(code)
