"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface, at first use, under
``build/gd_kernels/`` at the repository root (git-ignored), and loaded with
ctypes: pointers and the CUDA stream pass as ``c_void_p``, sizes as
``c_int64``. Every entry point returns the ``cudaError_t`` of its launch;
``check`` raises on a non-zero code. A missing ``nvcc``, a failed build or
a failed load raises: there is no fallback.

The process's one-time costs stay readable after a run: ``build_seconds``
and ``rebuilt`` (what this process compiled, and why), ``load_seconds``
(the freshness check, the load and the binding) and
``first_call_seconds`` (each entry point's first call, where the card
loads the kernel's module and launches it first).
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
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
#: flags of each source's compile (``-c``); the link adds ``-shared``
NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lib = None
#: seconds the last ``build_kernels`` call spent compiling (0.0 when cached)
build_seconds = 0.0
#: the sources and headers that made this process compile the library:
#: those newer than the library it found, or all where it found none or
#: the build was forced; empty where it loaded the library it found
rebuilt: list = []
#: seconds ``load_kernels`` spent checking the library's freshness,
#: loading it (``ctypes.CDLL``) and binding its entry points, a compile
#: left out
load_seconds = 0.0
#: host seconds of each entry point's first call in this process, by name
first_call_seconds: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    # (counts, packed, target, avail0, selend0, avail0i,
    #  out, availf, selendf, availfi,
    #  nbw, W, cap, B, L, grid_offset, auto_target, max_coverage, stream)
    "gd_blocked_sweep": [_P] * 10 + [_I] * 8 + [_P],
    # gd_blocked_sweep's arguments, with the workspace after availfi and
    # its bytes and the tier after max_coverage
    "gd_blocked_sweep_wide": [_P] * 11 + [_I] * 10 + [_P],
    # (packed, counts, sel, xwin, out, nbw, W, cap, B, L, hash, stream)
    "gd_blocked_select": [_P] * 5 + [_I] * 6 + [_P],
    # (rows, target, avail0, selend0, out, takes, availf, selendf,
    #  S, n, L, takes_mode, stream)
    "gd_dense_sweep": [_P] * 8 + [_I] * 4 + [_P],
    # (rows, target, out, n, L, stream)
    "gd_sweep_variant_c": [_P] * 3 + [_I] * 2 + [_P],
    "gd_sweep_variant_b": [_P] * 3 + [_I] * 2 + [_P],
    # (L, ring, info[4])
    "gd_sweep_variant_info": [_I, _I, _P],
    # (packed, target, out, availf, selendf, nbw, W, cap, B, L, mode, stream)
    "gd_blocked_ablate": [_P] * 5 + [_I] * 6 + [_P],
    # (B, L, mode, info[4])
    "gd_blocked_ablate_info": [_I, _I, _I, _P],
    # (bstart, bend1, off0, cap, pool, run_lo, run_hi, excess0, orderF,
    #  rangeF, orderB, rangeB, flow, scalars, ws, n, B, R, G, capF, capB,
    #  phase_cap, stream)
    "gd_ssp_solve": [_P] * 15 + [_I] * 7 + [_P],
    # (arcs, off, hopF, rangeF, grpF, grangeF, hopB, rangeB, grpB, grangeB,
    #  cap_src, cap_snk, excess0, label0, f_read, f_chain, f_src, f_snk,
    #  excess, label, scalars, ws, n, R, G, max_supersteps, relabel_every,
    #  nodes_in_ws, stream)
    "gd_push_relabel_solve": [_P] * 22 + [_I] * 6 + [_P],
    # (packed, counts, diff, fill, r, n, read_len, W, win, B, L, cap, stream)
    "gd_device_pack": [_P] * 4 + [_I] * 8 + [_P],
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
    and header exists; returns its path."""
    global build_seconds, rebuilt
    out = _BUILD_DIR / _LIB_NAME
    srcs = sorted(_CSRC.glob("*.cu"))
    found = out.stat().st_mtime if out.exists() else None
    stale = [s.name for s in (*srcs, *sorted(_CSRC.glob("*.cuh")))
             if force or found is None or s.stat().st_mtime > found]
    if not stale:
        build_seconds = 0.0
        return out
    rebuilt = stale
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build under private names, then rename: concurrent first uses never
    # load a half-written library
    tag = f"{os.getpid()}.tmp"
    objs = [out.with_name(f"{s.stem}.{tag}.o") for s in srcs]
    tmp = out.with_name(f"{_LIB_NAME}.{tag}")
    t0 = time.perf_counter()
    try:
        compiles = [
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
            for s, o in zip(srcs, objs)
        ]
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
            for cmd in compiles
        ]
        results = [p.communicate() for p in procs]
        for cmd, p, (_, err) in zip(compiles, procs, results):
            if p.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{err}"
                )
        link = [nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                f"{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        build_seconds = time.perf_counter() - t0
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return out


class _FirstCall:
    """An entry point of the library until its first call returns: that
    call is timed into ``first_call_seconds``, and the bare function put
    back in the library, so later calls cost nothing more."""

    __slots__ = ("lib", "name", "fn")

    def __init__(self, lib, name, fn):
        self.lib, self.name, self.fn = lib, name, fn

    def __call__(self, *args):
        if self.name in first_call_seconds:  # a caller that kept this object
            return self.fn(*args)
        t0 = time.perf_counter()
        try:
            return self.fn(*args)
        finally:
            first_call_seconds[self.name] = time.perf_counter() - t0
            setattr(self.lib, self.name, self.fn)

    def __getattr__(self, attr):  # argtypes, restype
        return getattr(self.fn, attr)


def load_kernels():
    """The loaded kernel library, building it first if needed."""
    global _lib, load_seconds
    if _lib is None:
        t0 = time.perf_counter()
        path = build_kernels()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelBuildError(f"cannot load {path}: {e}") from e
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
            setattr(lib, name, _FirstCall(lib, name, fn))
        lib.gd_cuda_error_string.restype = ctypes.c_char_p
        lib.gd_cuda_error_string.argtypes = [ctypes.c_int]
        _lib = lib
        load_seconds = time.perf_counter() - t0 - build_seconds
    return _lib


def check(name: str, rc: int) -> None:
    """Raise when a kernel entry point returned a CUDA error."""
    if rc != 0:
        msg = _lib.gd_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
