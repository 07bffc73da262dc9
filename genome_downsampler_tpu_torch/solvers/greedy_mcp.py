"""Exact unit-cost MCP via a farthest-endpoint greedy sweep (host solver).

The reference solves MCP as min-cost flow with OR-Tools cost-scaling
(``reference/libs/qmcp-solver/src/mcp_cpu_cost_scaling_solver.cpp``).
The flow network on the genome line (interval arcs cap 1, free backward chain
arcs, demands from the capped coverage) is equivalent to the LP

    min sum(x_i)  s.t.  sum_{i covers j} x_i >= min(cov(j), M)  for all j,
    0 <= x_i <= 1,

whose constraint matrix is an interval matrix (totally unimodular), so the
classic left-to-right greedy is *exact*: sweep positions; whenever selected
coverage at j falls short of the target, select the not-yet-selected reads
covering j with the farthest right endpoints. Exchange argument: positions
left of j are already satisfied by previously selected reads alone, and any
optimal completion using a shorter read o (end_o < end_r) at j can swap o for
r because [j, end_o] is a subset of [j, end_r].

This is O((R + n) log R) on host and serves as (a) the production CPU path
and (b) the exactness oracle for the device solvers (read-set equality target
per BASELINE.md). Deterministic tie-break: among equal endpoints, the lowest
read index wins.
"""

from __future__ import annotations

import heapq

import numpy as np

from genome_downsampler_tpu_torch.core.readbatch import ReadBatch
from genome_downsampler_tpu_torch.solvers.base import Solution, Solver


def greedy_mcp_select(
    start: np.ndarray,
    end: np.ndarray,
    genome_length: int,
    max_coverage: int,
    target: np.ndarray | None = None,
) -> np.ndarray:
    """Return sorted read indices of an optimal unit-cost selection.

    ``target`` overrides the per-base requirement (defaults to
    ``min(input_coverage, max_coverage)``); the windowed distributed path
    uses this to solve with externally adjusted demands.
    """
    n = int(genome_length)
    start = np.asarray(start, np.int64)
    end = np.asarray(end, np.int64)
    r = start.shape[0]

    if target is None:
        cov = np.zeros(n + 1, np.int64)
        np.add.at(cov, np.clip(start, 0, n), 1)
        np.add.at(cov, np.clip(end + 1, 0, n), -1)
        cov = np.cumsum(cov)[:n]
        target = np.minimum(cov, max_coverage)
    else:
        target = np.asarray(target, np.int64)

    order = np.argsort(start, kind="stable")
    sorted_start = start[order]
    # first index in `order` whose start >= j, for each j
    boundaries = np.searchsorted(sorted_start, np.arange(n + 1))

    selected = np.zeros(r, bool)
    dec_at = np.zeros(n + 2, np.int64)  # selected-coverage decrements
    heap: list[tuple[int, int]] = []  # (-end, read_index)
    cur = 0
    for j in range(n):
        for k in range(boundaries[j], boundaries[j + 1]):
            idx = order[k]
            heap_item = (-int(end[idx]), int(idx))
            heapq.heappush(heap, heap_item)
        cur -= dec_at[j]
        need = int(target[j]) - cur
        while need > 0:
            neg_e, idx = heapq.heappop(heap)
            e = -neg_e
            if e < j:
                continue  # expired candidate, cannot help any position >= j
            selected[idx] = True
            dec_at[e + 1] += 1
            cur += 1
            need -= 1
    return np.nonzero(selected)[0].astype(np.int64)


class GreedyMcpSolver(Solver):
    """Exact minimum-read-count solver (parity target: reference ``mcp-cpu``
    optimal objective, ``mcp_cpu_cost_scaling_solver.cpp:13-31``)."""

    uses_quality_of_reads = False

    def solve(self, max_coverage: int, batch: ReadBatch) -> Solution:
        return greedy_mcp_select(
            batch.start, batch.end, batch.ref_genome_length, max_coverage
        )
