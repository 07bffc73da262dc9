"""The global sequential water-filling sweep in torch, and the dense-engine
solvers built on kernel A.

Counterpart of the JAX package's ``solvers/device_sweep.py`` (the
algorithm and its proof are described there and in ``greedy_mcp.py``). One
genome position per step: fold in the reads starting there, take the
deficit against the capped target from the farthest-ending available
reads, emit the selected count whose reads end here, shift.

- ``build_start_rows`` builds the arrival histogram; ``sweep_counts`` and
  ``sweep_counts_with_takes`` are kernel A's plain twin on one row (an
  eager per-position loop), the oracles held against the JAX package.
- ``McpDeviceSweepSolver`` (``mcp-cuda``) runs the dense engine, kernel A
  on the ``(n, L)`` arrival histogram, while that histogram fits
  ``DENSE_ROWS_BUDGET_BYTES``, and the blocked engine
  (``solvers/blocked_sweep.py``) above it.
- ``QmcpDeviceSweepSolver`` (``qmcp-sweep-cuda``) keeps the minimum-count
  selection and assigns identities by quality from kernel A's take matrix.

``reconstruct_selection``, ``quality_aware_assignment`` and
``DENSE_ROWS_BUDGET_BYTES`` are copies of the JAX module's (which imports
JAX); the CPU tests hold each equal to its original.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from genome_downsampler_tpu_torch.core.readbatch import ReadBatch
from genome_downsampler_tpu_torch.solvers.base import Solution, Solver
from genome_downsampler_tpu_torch.utils.logging import get_logger
from genome_downsampler_tpu_torch.utils.profiling import annotate
from genome_downsampler_tpu_torch import _native
from genome_downsampler_tpu_torch.device import resolve_device
from genome_downsampler_tpu_torch.ops.coverage import (
    capped_coverage,
    coverage_from_intervals,
)
from genome_downsampler_tpu_torch.ops.sweep import (
    dense_sweep_counts,
    dense_sweep_counts_plain,
)

DEFAULT_MAX_SPAN = 256  # static bound on read span (end - start + 1)

# dense (n, L) int32 histogram budget before mcp-cuda switches to the
# O(R)-memory blocked engine
DENSE_ROWS_BUDGET_BYTES = 256 * 1024 * 1024

_log = get_logger("torch.solvers.device_sweep")


def build_start_rows(
    start: torch.Tensor, span: torch.Tensor, weight: torch.Tensor, n: int,
    max_span: int,
) -> torch.Tensor:
    """Dense (n, L) histogram: ``rows[j, k]`` = # reads with start=j,
    span=k+1; ``weight`` is 0 for padded slots."""
    idx = start.to(torch.int64) * max_span + (span.to(torch.int64) - 1)
    idx = idx.clamp(0, n * max_span - 1)
    flat = torch.zeros(n * max_span, dtype=torch.int32, device=start.device)
    flat.index_add_(0, idx, weight.to(torch.int32))
    return flat.reshape(n, max_span)


def sweep_counts(
    add_rows: torch.Tensor,  # int32[n, L]
    target: torch.Tensor,    # int32[n]
    avail0: torch.Tensor,    # int32[L] carry-in, zeros at the genome start
    selend0: torch.Tensor,   # int32[L]
    max_span: int = DEFAULT_MAX_SPAN,
):
    """Run the sweep; returns ``(sel_per_end[n], avail_out[L],
    selend_out[L])``, all int32. The plain twin of kernel A on one row."""
    out = dense_sweep_counts_plain(
        add_rows[None], target[None], avail0[None], selend0[None], max_span
    )
    return tuple(x[0] for x in out)


def sweep_counts_with_takes(
    add_rows: torch.Tensor,  # int32[n, L]
    target: torch.Tensor,    # int32[n]
    max_span: int = DEFAULT_MAX_SPAN,
) -> torch.Tensor:
    """The sweep from zero carries, emitting the take matrix ``takes[j, k]``
    = reads taken at position ``j`` from the bucket ending at ``j + k``."""
    z = torch.zeros((1, max_span), dtype=torch.int32, device=add_rows.device)
    takes, _, _ = dense_sweep_counts_plain(
        add_rows[None], target[None], z, z, max_span, takes=True
    )
    return takes[0]


def reconstruct_selection(
    start: np.ndarray,
    end: np.ndarray,
    sel_per_end: np.ndarray,
) -> np.ndarray:
    """Map per-end selected counts back to concrete read indices.

    Within each end bucket, consume reads in increasing (start, index)
    order — the only order guaranteed consistent with availability at take
    time. At 200,000 reads and above the threaded C counting sort
    (``_native.reconstruct``) does it; below, a numpy lexsort."""
    r = start.shape[0]
    if r >= 200_000:
        return _native.reconstruct(start, end, sel_per_end)
    order = np.lexsort((np.arange(r), start, end))
    e_sorted = end[order]
    # rank within each end group
    group_first = np.concatenate([[True], e_sorted[1:] != e_sorted[:-1]])
    idx = np.arange(r)
    first_idx = np.maximum.accumulate(np.where(group_first, idx, 0))
    rank = idx - first_idx
    take = sel_per_end[e_sorted] > rank
    return np.sort(order[take]).astype(np.int64)


def _check_spans(batch: ReadBatch, max_span: int) -> None:
    span_max = int((batch.end - batch.start).max()) + 1
    if span_max > max_span:
        raise ValueError(
            f"read span {span_max} exceeds max_span={max_span}; raise "
            "max_span (static) for this dataset, or use mcp-cuda-blocked"
        )


def _dense_inputs(batch: ReadBatch, n: int, max_coverage: int, max_span: int,
                  device: torch.device):
    """Capped target ``[1, n]`` and arrival rows ``[1, n, L]``, built on
    the device from the batch's intervals."""
    start = torch.as_tensor(np.asarray(batch.start, np.int64), device=device)
    end = torch.as_tensor(np.asarray(batch.end, np.int64), device=device)
    target = capped_coverage(coverage_from_intervals(start, end, n), max_coverage)
    ones = torch.ones(start.shape, dtype=torch.int32, device=device)
    rows = build_start_rows(start, end - start + 1, ones, n, max_span)
    return target[None], rows[None]


def _dense_pipeline(batch: ReadBatch, n: int, max_coverage: int,
                    max_span: int, device: torch.device, *, takes=False):
    """Coverage -> capped target -> rows -> kernel A, all on the device;
    returns ``sel_per_end[n]`` (or ``takes[n, L]`` with ``takes``)."""
    target, rows = _dense_inputs(batch, n, max_coverage, max_span, device)
    zeros = torch.zeros((1, max_span), dtype=torch.int32, device=device)
    out, _, _ = dense_sweep_counts(rows, target, zeros, zeros, max_span,
                                   takes=takes)
    return out[0]


class McpDeviceSweepSolver(Solver):
    """Exact minimum-read-count solver on the device (``mcp-cuda``).

    One name covers every scale: the dense engine (kernel A over the
    ``(n, L)`` arrival histogram) while the histogram fits
    ``DENSE_ROWS_BUDGET_BYTES``, i.e. genomes up to 262,144 bases at
    ``L = 256``, and the O(R)-memory blocked engine
    (``BlockedWindowedMcpSolver``) above — the same selection either way.
    Reads longer than ``max_span`` are refused at every genome size.

    ``device`` is required: ``"cuda"`` launches the kernels (and raises
    without a card), ``"cpu"`` runs their plain torch twins."""

    uses_quality_of_reads = False

    def __init__(
        self,
        device: str | torch.device,
        max_span: int = DEFAULT_MAX_SPAN,
        engine: str = "auto",
    ):
        self.device = resolve_device(device)
        self.max_span = max_span
        if engine not in ("auto", "dense", "blocked"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        # filled by solve(): the engine, and its phase laps in seconds
        self.last_stats: dict | None = None

    def _pick_engine(self, n: int) -> str:
        if self.engine != "auto":
            return self.engine
        dense_bytes = n * self.max_span * 4
        return "dense" if dense_bytes <= DENSE_ROWS_BUDGET_BYTES else "blocked"

    def solve(self, max_coverage: int, batch: ReadBatch) -> Solution:
        n = batch.ref_genome_length
        if batch.n_reads == 0:
            return np.zeros(0, np.int64)
        _check_spans(batch, self.max_span)
        if self._pick_engine(n) == "blocked":
            from genome_downsampler_tpu_torch.solvers.blocked_sweep import (
                BlockedWindowedMcpSolver,
            )

            blocked = BlockedWindowedMcpSolver(
                device=self.device, max_span=self.max_span
            )
            out = blocked.solve(max_coverage, batch)
            self.last_stats = dict(blocked.last_stats, engine="blocked")
            return out
        t0 = time.perf_counter()
        with annotate("dense.sweep"):
            sel_per_end = _dense_pipeline(
                batch, n, int(max_coverage), self.max_span, self.device
            ).cpu().numpy()
        t1 = time.perf_counter()
        with annotate("dense.reconstruct"):
            out = reconstruct_selection(
                np.asarray(batch.start, np.int64), np.asarray(batch.end, np.int64),
                sel_per_end,
            )
        t2 = time.perf_counter()
        self.last_stats = {
            "engine": "dense", "max_span": self.max_span,
            "device": str(self.device),
            "phases_s": {"sweep": t1 - t0, "reconstruct": t2 - t1},
        }
        _log.debug("dense solve: %s", self.last_stats["phases_s"])
        return out


def quality_aware_assignment(
    start: np.ndarray,
    end: np.ndarray,
    quality: np.ndarray,
    takes_j: np.ndarray,  # int64[T] take positions (one entry per unit)
    takes_e: np.ndarray,  # int64[T] absolute end bucket per take
) -> np.ndarray:
    """Pick concrete reads for the sweep's take events, maximizing quality.

    Per end bucket, a take at position ``j`` may be served by any unused
    bucket read with ``start <= j`` — the unit-jobs-with-deadlines profit
    problem (reads sorted by quality descending, each assigned to the
    earliest free take slot whose position is >= its start) solved with a
    next-free-slot DSU. Selection counts (and therefore validity and the
    minimum-count optimum) are untouched; only identities change.
    """
    r = len(start)
    t = len(takes_j)
    if t == 0:
        return np.zeros(0, np.int64)
    # group take slots by bucket, positions ascending
    slot_order = np.lexsort((takes_j, takes_e))
    slot_e = takes_e[slot_order]
    slot_j = takes_j[slot_order]
    bucket_first = np.searchsorted(slot_e, np.arange(slot_e.max() + 2))

    # DSU "next free slot at or after index i" within each bucket
    parent = np.arange(t + 1, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    order = np.lexsort((np.arange(r), start, -quality))
    selected = np.zeros(r, bool)
    for i in order:
        e = end[i]
        if e >= len(bucket_first) - 1:
            continue
        lo, hi = bucket_first[e], bucket_first[e + 1]
        if lo == hi:
            continue
        # earliest slot in [lo, hi) with position >= start[i] that is free
        first_ok = lo + np.searchsorted(slot_j[lo:hi], start[i])
        s = find(first_ok)
        if s < hi:
            parent[s] = s + 1
            selected[i] = True
    return np.nonzero(selected)[0].astype(np.int64)


class QmcpDeviceSweepSolver(Solver):
    """Quality-preferring device solver (``qmcp-sweep-cuda``).

    Keeps the sweep's minimum-*count* selection and assigns identities to
    maximize total quality within it (deadline matching per end bucket);
    the exact weighted optimum is the host ``qmcp-cpu``. Kernel A runs in
    takes mode on the dense ``(n, L)`` histogram at every genome size, as
    ``qmcp-sweep-tpu`` does; only the non-zero ``(j, k, count)`` triples of
    the take matrix leave the device.

    ``device`` is required: ``"cuda"`` launches kernel A (and raises
    without a card), ``"cpu"`` runs its plain twin."""

    uses_quality_of_reads = True

    def __init__(self, device: str | torch.device,
                 max_span: int = DEFAULT_MAX_SPAN):
        self.device = resolve_device(device)
        self.max_span = max_span

    def solve(self, max_coverage: int, batch: ReadBatch) -> Solution:
        n = batch.ref_genome_length
        if batch.n_reads == 0:
            return np.zeros(0, np.int64)
        _check_spans(batch, self.max_span)
        takes = _dense_pipeline(
            batch, n, int(max_coverage), self.max_span, self.device, takes=True
        )
        nz = torch.nonzero(takes)
        counts = takes[nz[:, 0], nz[:, 1]].cpu().numpy()
        jj, kk = nz.cpu().numpy().T
        return quality_aware_assignment(
            np.asarray(batch.start, np.int64),
            np.asarray(batch.end, np.int64),
            np.asarray(batch.quality, np.int64),
            np.repeat(jj, counts).astype(np.int64),
            np.repeat(jj + kk, counts).astype(np.int64),
        )
