"""Exact weighted (QMCP) selection via the interval LP — host oracle solver.

The reference ``qmcp-cpu`` minimizes ``sum(max_quality - quality_i + 1)``
over selections meeting the capped-coverage target, solved as min-cost flow
(``reference/libs/qmcp-solver/src/qmcp_cpu_cost_scaling_solver.cpp``).
The equivalent LP

    min c.x   s.t.   sum_{i covers j} x_i >= target_j,  0 <= x_i <= 1

has an interval (totally unimodular) constraint matrix, so every simplex
vertex optimum is integral. We solve it with scipy's HiGHS dual simplex over
a sparse matrix with one constraint row per *event segment* (between
consecutive read endpoints the covering set is constant, so only the max
target in the segment binds) and round the vertex solution.

This is the exactness oracle for the device solvers and the ``qmcp-cpu``
registry entry. Practical size: ~hundreds of thousands of reads; the
sweep solvers handle production scale.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.optimize import linprog

from genome_downsampler_tpu_torch.core.readbatch import ReadBatch
from genome_downsampler_tpu_torch.solvers.base import Solution, Solver
from genome_downsampler_tpu_torch.utils.logging import get_logger

_log = get_logger("solvers.qmcp")


def _segment_rows(start, end, n, target):
    """Collapse per-base constraints to one row per event segment.

    Returns (seg_lo, seg_target): representative position and binding target
    for each segment with a positive requirement.
    """
    events = np.unique(np.concatenate([[0], start, end + 1, [n]]))
    events = events[(events >= 0) & (events <= n)]
    seg_lo = events[:-1]
    seg_hi = events[1:]  # exclusive
    # binding target per segment = max target within it
    seg_target = np.maximum.reduceat(target, seg_lo)
    keep = (seg_target > 0) & (seg_lo < seg_hi)
    return seg_lo[keep], seg_target[keep]


def lp_select(
    start: np.ndarray,
    end: np.ndarray,
    n: int,
    target: np.ndarray,
    cost: np.ndarray,
) -> np.ndarray:
    """Exact min-cost selection meeting ``target`` coverage. Returns indices."""
    r = len(start)
    if r == 0 or target.max(initial=0) <= 0:
        return np.zeros(0, np.int64)
    seg_lo, seg_target = _segment_rows(start, end, n, target)
    m = len(seg_lo)
    # A[s, i] = 1 iff read i covers segment s (covers iff start<=lo and end>=lo,
    # segments never straddle a read boundary)
    first_seg = np.searchsorted(seg_lo, start, side="left")
    last_seg = np.searchsorted(seg_lo, end, side="right") - 1
    counts = np.maximum(last_seg - first_seg + 1, 0)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    rows = np.concatenate(
        [np.arange(f, f + c) for f, c in zip(first_seg, counts)]
    ) if counts.sum() else np.zeros(0, np.int64)
    data = np.ones(len(rows), np.float64)
    a_ub = sp.csc_matrix(
        (data, rows, indptr), shape=(m, r)
    )  # columns are reads
    res = linprog(
        c=cost.astype(np.float64),
        A_ub=-a_ub,
        b_ub=-seg_target.astype(np.float64),
        bounds=(0, 1),
        method="highs-ds",
    )
    if not res.success:
        raise RuntimeError(f"LP solve failed: {res.message}")
    x = np.asarray(res.x)
    sel = np.nonzero(x > 0.5)[0]
    frac = np.abs(x - np.round(x)).max()
    if frac > 1e-6:
        _log.error("LP vertex not integral (max frac %.2e); rounding", frac)
    return sel.astype(np.int64)


def capped_target(start, end, n, max_coverage):
    cov = np.zeros(n + 1, np.int64)
    np.add.at(cov, np.clip(start, 0, n), 1)
    np.add.at(cov, np.clip(end + 1, 0, n), -1)
    cov = np.cumsum(cov)[:n]
    return np.minimum(cov, max_coverage)


class QmcpSequentialSolver(Solver):
    """Exact quality-weighted solver (parity target: reference ``qmcp-cpu``
    optimal objective, cost = ``max_quality - quality + 1``)."""

    uses_quality_of_reads = True

    def solve(self, max_coverage: int, batch: ReadBatch) -> Solution:
        start = np.asarray(batch.start, np.int64)
        end = np.asarray(batch.end, np.int64)
        n = batch.ref_genome_length
        target = capped_target(start, end, n, max_coverage)
        max_q = int(batch.quality.max(initial=0))
        cost = (max_q - np.asarray(batch.quality, np.int64) + 1).astype(np.float64)
        return lp_select(start, end, n, target, cost)


class McpLpOracle:
    """Unit-cost LP oracle (not registered): independent check of the greedy
    and sweep solvers' optimal counts."""

    @staticmethod
    def optimal_count(start, end, n, max_coverage) -> int:
        target = capped_target(start, end, n, max_coverage)
        sel = lp_select(start, end, n, target, np.ones(len(start)))
        return len(sel)
