"""ctypes binding for the C++ exact greedy (io/csrc/greedy.cpp).

The C-speed host production path for very large read sets (BASELINE config 5
scale); bit-compatible with the device sweep solvers (same counts and
earliest-start-per-end-bucket tie-break).
"""

from __future__ import annotations

import ctypes

import numpy as np

from genome_downsampler_tpu_torch._native import host_lib
from genome_downsampler_tpu_torch.core.readbatch import ReadBatch
from genome_downsampler_tpu_torch.solvers.base import Solution, Solver


def native_greedy_select(
    start: np.ndarray,
    end: np.ndarray,
    genome_length: int,
    max_coverage: int,
    target: np.ndarray | None = None,
) -> np.ndarray:
    lib = host_lib()
    s = np.ascontiguousarray(start, np.int64)
    e = np.ascontiguousarray(end, np.int64)
    tgt_ptr = None
    if target is not None:
        t = np.ascontiguousarray(target, np.int64)
        tgt_ptr = t.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    out = ctypes.POINTER(ctypes.c_int64)()
    count = lib.gd_greedy_mcp(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        e.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(s), genome_length, max_coverage, tgt_ptr, ctypes.byref(out),
    )
    if count < 0:
        raise ValueError("gd_greedy_mcp: invalid input (bounds or spans)")
    try:
        if count == 0:
            return np.zeros(0, np.int64)
        return np.ctypeslib.as_array(out, shape=(count,)).astype(np.int64, copy=True)
    finally:
        lib.gd_free_i64(out)


class NativeGreedyMcpSolver(Solver):
    """Exact MCP, C++ sweep (registered as the ``mcp-cpu`` fast path)."""

    uses_quality_of_reads = False

    def solve(self, max_coverage: int, batch: ReadBatch) -> Solution:
        return native_greedy_select(
            batch.start, batch.end, batch.ref_genome_length, max_coverage
        )
