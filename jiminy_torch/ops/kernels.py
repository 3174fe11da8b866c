"""Build and bind the port's CUDA kernels (`csrc/*.cu`).

Each source is compiled by nvcc for sm_90a into a shared library with a plain
C interface, at first use, into `build/jiminy_torch/` beside the package
(listed in `.gitignore`), and bound with ctypes. `cdyn.cu` is compiled in
parts (`CDYN_PART`, one nvcc each, all started together) whose objects are
linked into the one library. The library file name carries a hash of the
source and the flags, so an edit rebuilds and an unchanged tree reuses the
build. Nothing here runs at import time.
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
HEADERS = (CSRC_DIR / "cdyn.cuh", CSRC_DIR / "pgs.cuh", CSRC_DIR / "spring.cuh",
           CSRC_DIR / "terrain.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# The parts of cdyn.cu (CDYN_PART 0 to N_PARTS - 1): the host helpers, the
# spring kernels at float and double, cdyn_period_cm and cdyn_rollout_cm at
# float and double
N_PARTS = 7
CM_PHASES = 8  # phases of a constrained solve timed by a CDYN_CM_PROFILE build

_P, _I = ctypes.c_void_p, ctypes.c_int
# Each entry's last arguments: for the constrained kernels the envs a block
# (`Library.cm_geometry`), the terrain flag (the instance that evaluates the
# model's terrain section), for the constrained kernels the ext flag (the
# instance of the extended body: loop closures, spring-damper contacts and
# penalty bounds beside the rows), and the stream.
_SIGNATURES = {
    "cdyn_accel": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "cdyn_period": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "cdyn_rollout": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "cdyn_period_cm": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "cdyn_rollout_cm": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
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
    part_seconds: tuple = ()  # each part's nvcc time (a build in parts)


def _run_nvcc(commands: list) -> tuple:
    """Run the nvcc `commands` all at once; (their outputs, each one's
    seconds to its end). Raises if one fails."""
    import tempfile

    t0 = time.perf_counter()
    logs = [tempfile.TemporaryFile("w+") for _ in commands]
    try:
        procs = [subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, text=True)
                 for cmd, f in zip(commands, logs)]
        seconds = [None] * len(procs)
        while None in seconds:
            for i, proc in enumerate(procs):
                if seconds[i] is None and proc.poll() is not None:
                    seconds[i] = time.perf_counter() - t0
            time.sleep(0.1)
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
    finally:
        for f in logs:
            f.close()
    for cmd, proc, text in zip(commands, procs, texts):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{text}")
    return texts, seconds


def build(source: Path = SOURCE, defines: tuple = ()) -> BuildResult:
    """Compile `source` unless a build of the same source and flags exists.
    `defines` are preprocessor macros, each a build of its own:
    `CDYN_CM_PROFILE` (the constrained solve's phase timing; built whole,
    not in parts),
    `CDYN_CM_LANES=n`, `CDYN_CM_ENVS=n` (another launch geometry of the
    constrained kernels: lanes an env, the most envs a block), `CDYN_SP_LANES=n`, `CDYN_SP_ENVS=n` (of the spring
    kernels; the lanes are cdyn_accel's too), `CDYN_ACCEL_ENVS=n` (envs a
    block of cdyn_accel). `cdyn.cu` builds in its N_PARTS parts, each
    compiled by an nvcc of its own, all at once, then linked."""
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    digest = hashlib.sha256()
    for p in (source, *HEADERS):
        digest.update(p.read_bytes())
    digest.update(" ".join(flags).encode())
    key = digest.hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"lib{source.stem}_{key}.so"
    log = lib.with_suffix(".ptxas.txt")
    if lib.exists() and log.exists():
        return BuildResult(lib, log.read_text(), 0.0, True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    include = ("-I", str(CSRC_DIR))
    t0 = time.perf_counter()
    if source == SOURCE and "CDYN_CM_PROFILE" not in defines:
        compile_flags = tuple(f for f in flags if f != "-shared")
        objs = [lib.with_suffix(f".{os.getpid()}.part{n}.o") for n in range(N_PARTS)]
        texts, part_seconds = _run_nvcc(
            [[nvcc_path(), *compile_flags, f"-DCDYN_PART={n}", *include, "-c", "-o", str(obj),
              str(source)] for n, obj in enumerate(objs)])
        texts += _run_nvcc([[nvcc_path(), "-shared", "-o", str(tmp), *map(str, objs)]])[0]
        for obj in objs:
            obj.unlink()
    else:
        texts, part_seconds = _run_nvcc([[nvcc_path(), *flags, *include, "-o", str(tmp),
                                          str(source)]])
    seconds = time.perf_counter() - t0
    log.write_text("".join(texts))
    os.replace(tmp, lib)
    return BuildResult(lib, log.read_text(), seconds, False, tuple(part_seconds))


class Library:
    """The bound kernel library: `entry(name, dtype)`, the shared-memory
    slices and the constrained kernels' launch geometry."""

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
        self._cm_smem = self._dll.cdyn_cm_smem_bytes
        self._cm_smem.argtypes = [_I] * 14
        self._cm_smem.restype = ctypes.c_int
        self._sp_smem = self._dll.cdyn_sp_smem_bytes
        self._sp_smem.argtypes = [_I] * 8 + [ctypes.POINTER(ctypes.c_int)]
        self._sp_smem.restype = ctypes.c_int
        self._accel_smem = self._dll.cdyn_accel_smem_bytes
        self._accel_smem.argtypes = [_I] * 5 + [ctypes.POINTER(ctypes.c_int)]
        self._accel_smem.restype = ctypes.c_int
        self._sp_blocks = self._dll.cdyn_sp_blocks_per_sm
        self._sp_blocks.argtypes = [_I] * 4
        self._sp_blocks.restype = ctypes.c_int
        self._cm_geometry = self._dll.cdyn_cm_geometry
        self._cm_geometry.argtypes = [_I] * 5 + [ctypes.POINTER(ctypes.c_int)]
        self._cm_geometry.restype = ctypes.c_int
        self._cm_geometries = {}
        self._phases = getattr(self._dll, "cdyn_cm_phase_cycles", None)
        if self._phases is not None:
            self._phases.argtypes = [_P]
            self._phases.restype = ctypes.c_int
        self._err = self._dll.cdyn_error_string
        self._err.argtypes = [ctypes.c_int]
        self._err.restype = ctypes.c_char_p

    def entry(self, name: str, dtype):
        try:
            return self._entries[(name, dtype)]
        except KeyError:
            raise ValueError(f"no kernel {name} for dtype {dtype}") from None

    def cm_smem_bytes(self, nj, nq, nv, n_rows, nc, nb, ns, nd, n_spring, nr, n_cmd, n_action,
                      n_block, elt) -> int:
        """Bytes of dynamic shared memory one env of the constrained kernels
        takes (`CmLayout`, `cm_env_stride` in csrc/pgs.cuh) with nd loop
        closures, n_spring spring-damper contacts and nr rolling constraints
        beside the rows, and the launch's command, action and controller-carry
        widths."""
        return int(self._cm_smem(nj, nq, nv, n_rows, nc, nb, ns, nd, n_spring, nr, n_cmd,
                                 n_action, n_block, elt))

    def sp_smem_bytes(self, nj, nq, nv, nc, n_cmd, n_action, n_carry, elt) -> tuple:
        """(bytes of dynamic shared memory one env of the spring kernels
        takes, lanes per env, envs per block) of this build (`SpLayout`,
        `sp_env_stride` in csrc/spring.cuh)."""
        geometry = (ctypes.c_int * 2)()
        per_env = self._sp_smem(nj, nq, nv, nc, n_cmd, n_action, n_carry, elt, geometry)
        return int(per_env), int(geometry[0]), int(geometry[1])

    def accel_smem_bytes(self, nj, nq, nv, nc, elt) -> tuple:
        """(bytes of dynamic shared memory one env of cdyn_accel takes, lanes
        per env, envs per block) of this build (`SpAccelLayout` in
        csrc/spring.cuh)."""
        geometry = (ctypes.c_int * 2)()
        per_env = self._accel_smem(nj, nq, nv, nc, elt, geometry)
        return int(per_env), int(geometry[0]), int(geometry[1])

    def sp_envs_per_sm(self, kernel: str, elt: int, smem_per_env: int, terrain=False) -> int:
        """Envs of a spring kernel ("cdyn_accel", "cdyn_period" or
        "cdyn_rollout"; its terrain instance with `terrain`) that the runtime
        keeps on one SM (`cudaOccupancyMaxActiveBlocksPerMultiprocessor` x
        envs a block)."""
        which = ("cdyn_accel", "cdyn_period", "cdyn_rollout").index(kernel)
        blocks = self._sp_blocks(which, elt, smem_per_env, int(terrain))
        if blocks < 0:
            raise RuntimeError(f"cdyn_sp_blocks_per_sm: CUDA error {-blocks} "
                               f"({self.error_string(-blocks)})")
        geometry = (self.accel_smem_bytes(1, 1, 1, 0, elt) if which == 0 else
                    self.sp_smem_bytes(1, 1, 1, 0, 0, 0, 0, elt))
        return blocks * geometry[2]

    def cm_geometry(self, kernel: str, elt: int, smem_per_env: int, terrain=False,
                    ext=False) -> tuple:
        """(envs a block, envs an SM) of a constrained kernel
        ("cdyn_period_cm" or "cdyn_rollout_cm"; its terrain instance with
        `terrain`, its extended body with `ext`) with `smem_per_env` bytes an
        env: of 1 to CDYN_CM_ENVS envs a block, the count of which the runtime
        keeps the most envs on one SM (`cdyn_cm_geometry`), once per key.
        Raises where not even a block of one env fits."""
        key = (kernel, elt, smem_per_env, bool(terrain), bool(ext))
        if key not in self._cm_geometries:
            which = ("cdyn_period_cm", "cdyn_rollout_cm").index(kernel)
            out = (ctypes.c_int * 2)()
            rc = self._cm_geometry(which, elt, smem_per_env, int(terrain), int(ext), out)
            if rc != 0:
                raise RuntimeError(f"{kernel}: no block of {smem_per_env} B an env fits on the "
                                   f"card: CUDA error {rc} ({self.error_string(rc)})")
            self._cm_geometries[key] = (int(out[0]), int(out[1]))
        return self._cm_geometries[key]

    def cm_phase_cycles(self) -> list:
        """Cycles the constrained solves spent in each phase since the last
        call (a build with `CDYN_CM_PROFILE` only), then zeroed."""
        if self._phases is None:
            raise RuntimeError("this build has no phase timing (build with CDYN_CM_PROFILE)")
        buf = (ctypes.c_ulonglong * CM_PHASES)()
        rc = self._phases(ctypes.cast(buf, ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"cdyn_cm_phase_cycles: CUDA error {rc} ({self.error_string(rc)})")
        return list(buf)

    def error_string(self, code: int) -> str:
        return self._err(int(code)).decode()


_LIBRARY: Optional[Library] = None
_DEFINES: tuple = ()


def load(defines: tuple = ()) -> Library:
    """Build (if needed) and bind the kernels once per process. A process
    that wants another build (`defines`, see `build`) asks for it before
    any kernel runs; it then serves every launch of that process."""
    global _LIBRARY, _DEFINES
    if _LIBRARY is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the cdyn kernels need a CUDA device")
        _LIBRARY, _DEFINES = Library(build(defines=tuple(defines))), tuple(defines)
    elif defines and tuple(defines) != _DEFINES:
        raise RuntimeError(f"the kernels are already loaded with defines {_DEFINES}")
    return _LIBRARY


def error_string(code: int) -> str:
    return load().error_string(code)
