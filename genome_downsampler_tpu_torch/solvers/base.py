"""Solver interface.

Mirrors the reference abstract solver
(``reference/libs/qmcp-solver/include/qmcp-solver/solver.hpp:15-20``):
``solve(max_coverage, reads) -> Solution`` plus ``uses_quality_of_reads``
(which the app layer uses to pick amplicon GRADE vs FILTER behaviour,
``reference/src/app.cpp:120-128``).

A ``Solution`` is an int64 array of *read indices* (positions in the
``ReadBatch``, not BAM line ids — the reference's ``ReadIndex`` vs
``BAMReadId`` distinction, ``read.hpp:11-14``).
"""

from __future__ import annotations

import abc
import itertools
import sys

import numpy as np

from genome_downsampler_tpu_torch.core.readbatch import ReadBatch

Solution = np.ndarray  # int64[k] read indices


class Solver(abc.ABC):
    """Abstract read-selection solver."""

    #: Whether arc costs derive from MAPQ (True selects amplicon GRADE
    #: behaviour in the app layer, False selects FILTER).
    uses_quality_of_reads: bool = False

    @abc.abstractmethod
    def solve(self, max_coverage: int, batch: ReadBatch) -> Solution:
        """Select read indices whose coverage reaches
        ``min(input_coverage, max_coverage)`` at every base."""
        raise NotImplementedError


class SpanGuard(Solver):
    """Shields a solver from zero-reference-span reads.

    A fully-soft-clipped CIGAR consumes no reference, so the reader imports
    it with ``end == start - 1`` (``pos + rlen - 1`` with ``rlen = 0`` —
    the reference's ``read.cpp:11-13`` semantics). Such a read contributes
    nothing to coverage and its per-read cost is positive, so no optimum
    ever needs it; the reference feeds it to OR-Tools as a ``start ->
    start`` self-loop arc that likewise never carries flow
    (``quasi_mcp_cpu_max_flow_solver.cpp:34-36``). Several engines here
    index buckets by ``end`` or encode ``span - 1``, so the registry
    removes these reads before the solve and maps indices back. Pair
    integrity is unaffected: ``find_pairs`` runs on the original batch.

    Each solve is the profiler region ``entry.solve``, the root of the
    solvers' own regions, with the process's solve number (from 1) as its
    args; where torch is not loaded (a host-only solver) no profiler can
    run, and there is no region.
    """

    _solves = itertools.count(1)

    def __init__(self, inner: Solver):
        self.inner = inner
        self.uses_quality_of_reads = inner.uses_quality_of_reads

    def solve(self, max_coverage: int, batch: ReadBatch) -> Solution:
        number = next(SpanGuard._solves)
        if "torch" not in sys.modules:
            return self._solve(max_coverage, batch)
        from genome_downsampler_tpu_torch.utils.profiling import annotate

        with annotate("entry.solve", str(number)):
            return self._solve(max_coverage, batch)

    def _solve(self, max_coverage: int, batch: ReadBatch) -> Solution:
        ok = batch.end >= batch.start
        if bool(ok.all()):
            return self.inner.solve(max_coverage, batch)
        keep = np.flatnonzero(ok)
        sel = np.asarray(
            self.inner.solve(max_coverage, batch.select(keep)), np.int64
        )
        return np.sort(keep[sel])
