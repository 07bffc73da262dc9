"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, at first use, under
``build/gd_kernels/`` at the repository root (git-ignored), and loaded with
ctypes: pointers and the CUDA stream pass as ``c_void_p``, sizes as
``c_int64``. Every entry point returns the ``cudaError_t`` of its launch;
``check`` raises on a non-zero code. A missing ``nvcc``, a failed build or
a failed load raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gd_kernels"
_LIB_NAME = "libgd_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_lib = None
#: seconds the last ``build_kernels`` call spent compiling (0.0 when cached)
build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    # (counts, packed, target, avail0, selend0, avail0i,
    #  out, availf, selendf, availfi,
    #  nbw, W, cap, B, L, grid_offset, auto_target, max_coverage, stream)
    "gd_blocked_sweep": [_P] * 10 + [_I] * 8 + [_P],
    # (packed, counts, sel, xwin, out, nbw, W, cap, B, L, stream)
    "gd_blocked_select": [_P] * 5 + [_I] * 5 + [_P],
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or failed, or the built library does not load."""


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and Path(os.environ["CUDA_HOME"]) / "bin/nvcc",
        shutil.which("nvcc"),
        Path("/usr/local/cuda/bin/nvcc"),
    ):
        if cand and Path(cand).exists():
            return str(cand)
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from source at first use"
    )


def build_kernels(force: bool = False) -> Path:
    """Compile ``ops/csrc/*.cu`` unless a library newer than every source
    exists; returns its path."""
    global build_seconds
    out = _BUILD_DIR / _LIB_NAME
    srcs = sorted(_CSRC.glob("*.cu"))
    newest = max(s.stat().st_mtime for s in srcs)
    if not force and out.exists() and out.stat().st_mtime >= newest:
        build_seconds = 0.0
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: concurrent first uses never
    # load a half-written library
    tmp = out.with_name(f"{_LIB_NAME}.{os.getpid()}.tmp")
    cmd = [
        _nvcc(), *NVCC_FLAGS, "-o", str(tmp),
        *[str(s) for s in srcs],
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load_kernels():
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is None:
        path = build_kernels()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelBuildError(f"cannot load {path}: {e}") from e
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        lib.gd_cuda_error_string.restype = ctypes.c_char_p
        lib.gd_cuda_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def check(name: str, rc: int) -> None:
    """Raise when a kernel entry point returned a CUDA error."""
    if rc != 0:
        msg = _lib.gd_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
