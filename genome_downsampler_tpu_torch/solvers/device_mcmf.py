"""Device-exact weighted QMCP: successive shortest paths (``qmcp-cuda``).

Counterpart of the JAX package's ``solvers/device_mcmf.py``, where the
network and the scan-based SSP are described. The host half is copied here
(``build_convex_buckets``, ``_run_tables``, ``_node_excess`` and the
constants; the CPU tests hold each equal to its original); the device half,
the JAX program's ``solve_loop``, is the SSP kernel behind
``ops.ssp.ssp_solve``: the whole loop of phases in one launch.

``QmcpDeviceMcmfSolver`` keeps the JAX solver's size dispatch: genomes
longer than ``DEVICE_GENOME_LIMIT`` go to the host C++ MCMF
(``mcmf_select_convex``). A device run that ends in a status other than
``OK`` raises ``SspStatusError``, as a build, launch or CUDA error raises:
nothing on the device path is answered by the host instead.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from genome_downsampler_tpu_torch.core.readbatch import ReadBatch
from genome_downsampler_tpu_torch.device import resolve_device
from genome_downsampler_tpu_torch.ops.ssp import (  # noqa: F401 (re-exported)
    _STATUS_MSG,
    DEGENERATE,
    FIXPOINT_CAP,
    IMAX,
    INF,
    INFEASIBLE,
    OK,
    PATH_OVERFLOW,
    PI_GUARD,
    PI_OVERFLOW,
    ssp_solve,
)
from genome_downsampler_tpu_torch.solvers.base import Solution, Solver
from genome_downsampler_tpu_torch.solvers.native_mcmf import mcmf_select_convex
from genome_downsampler_tpu_torch.utils.logging import get_logger
from genome_downsampler_tpu_torch.utils.profiling import annotate

_log = get_logger("torch.solvers.device_mcmf")

# n above which qmcp-cuda hands the solve to the host C++ MCMF: the JAX
# solver's limit (the fixpoint's rounds per phase grow with n / span), not
# a crossover measured on the card
DEVICE_GENOME_LIMIT = 131_072


class SspStatusError(RuntimeError):
    """The device SSP stopped with a status other than ``OK``."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


def build_convex_buckets(start, end, cost):
    """Group reads by (start, end) with per-bucket costs sorted ascending.

    Returns (bstart, bend, off, pool, order, first): ``pool[off[b]:off[b+1]]``
    are bucket ``b``'s unit costs ascending; ``order[k]`` is the read index
    of pool entry ``k``; ``first[k]`` marks a bucket's first entry. One
    stable argsort of a composite key when ranges permit, else a lexsort.
    """
    s = np.asarray(start, np.int64)
    e = np.asarray(end, np.int64)
    c = np.asarray(cost, np.int64)
    r = s.shape[0]
    span = e - s + 1
    if (
        r
        and int(span.max()) < (1 << 12)
        and int(c.max()) < (1 << 10)
        and int(c.min()) >= 0
        and int(s.max()) < (1 << 41)
        and int(s.min()) >= 0
    ):
        key = (s << 22) | (span << 10) | c
        order = np.argsort(key, kind="stable")
        ks = key[order]
        gkey = ks >> 10
        first = np.empty(r, bool)
        first[0] = True
        np.not_equal(gkey[1:], gkey[:-1], out=first[1:])
        pool = ks & ((1 << 10) - 1)
        starts_idx = np.flatnonzero(first)
        gu = gkey[starts_idx]
        bs = gu >> 12
        be = bs + (gu & ((1 << 12) - 1)) - 1
    else:
        order = np.lexsort((np.arange(r), c, e, s))
        ss, ee = s[order], e[order]
        first = np.empty(max(r, 1), bool)
        first[0] = True
        if r:
            first[1:r] = (ss[1:] != ss[:-1]) | (ee[1:] != ee[:-1])
        first = first[:r]
        pool = c[order]
        starts_idx = np.flatnonzero(first)
        bs = ss[starts_idx]
        be = ee[starts_idx]
    off = np.append(starts_idx, r).astype(np.int64)
    return bs, be, off, np.ascontiguousarray(pool), order, first


def _run_tables(pool: np.ndarray, first: np.ndarray):
    """run_lo/run_hi[k]: first/last pool index of the equal-cost run
    containing k, within its bucket (pool is sorted per bucket)."""
    r = pool.shape[0]
    new_run = first.copy()
    if r > 1:
        new_run[1:] |= pool[1:] != pool[:-1]
    run_starts = np.flatnonzero(new_run)
    run_id = np.cumsum(new_run) - 1
    run_lo = run_starts[run_id]
    run_hi = np.append(run_starts[1:], r)[run_id] - 1
    return run_lo.astype(np.int32), run_hi.astype(np.int32)


def _node_excess(bstart, bend, caps, n: int, max_coverage: int) -> np.ndarray:
    """Supplies = -demand from the capped coverage difference (the
    reference's ``create_demand_function``, sign-inverted)."""
    bcov = np.zeros(n + 2, np.int64)
    np.add.at(bcov, bstart + 1, caps)
    np.add.at(bcov, bend + 2, -caps)
    bcov = np.minimum(np.cumsum(bcov), max_coverage)
    excess = np.zeros(n + 1, np.int64)
    excess[0] = bcov[1]
    excess[1:n] = bcov[2 : n + 1] - bcov[1:n]
    excess[n] = -bcov[n]
    return excess


def ssp_device_flows(
    bstart: np.ndarray,
    bend: np.ndarray,
    off: np.ndarray,
    pool: np.ndarray,
    first: np.ndarray,
    n: int,
    max_coverage: int,
    device: str | torch.device,
    stats: dict | None = None,
) -> np.ndarray:
    """Per-bucket take counts of the exact optimum, by the SSP on
    ``device``, which the caller names (``"cuda"``: the kernel, raising
    without a card; ``"cpu"``: its twin). ``stats``, if given, receives
    ``phases`` and ``rounds``, and on the card the kernel's laps
    ``rounds_ns``, ``tables_ns`` and ``phase_end_ns`` (``ops/ssp.py``).
    Raises ``SspStatusError`` when the run ends in a status other than
    ``OK``."""
    dev = resolve_device(device)
    B = bstart.shape[0]
    caps = np.diff(off)
    excess0 = _node_excess(bstart, bend, caps, n, max_coverage)
    supply0 = int(excess0[excess0 > 0].sum())
    if stats is not None:
        stats.update(phases=0, rounds=0)
    if supply0 == 0 or B == 0:
        return np.zeros(B, np.int64)
    if abs(int(excess0.min())) >= INF or supply0 >= INF:
        raise ValueError("supply exceeds int32 device budget")
    run_lo, run_hi = _run_tables(pool, first)

    def i32(x):
        return torch.tensor(np.ascontiguousarray(x, np.int32), device=dev)

    flow, supply, status, phases, rounds = ssp_solve(
        i32(bstart), i32(bend + 1), i32(off[:B]), i32(caps), i32(pool),
        i32(run_lo), i32(run_hi), i32(excess0), supply0 + 16, laps=stats,
    )
    if stats is not None:
        stats.update(phases=phases, rounds=rounds)
    if status != OK:
        raise SspStatusError(
            status,
            f"device SSP failed after {phases} phases "
            f"(supply {supply}/{supply0}): {_STATUS_MSG[status]}",
        )
    _log.debug("device SSP: %d phases, %d rounds for supply %d", phases, rounds,
               supply0)
    return flow.cpu().numpy().astype(np.int64)


def ssp_device_select(
    start: np.ndarray,
    end: np.ndarray,
    cost: np.ndarray,
    n: int,
    max_coverage: int,
    device: str | torch.device,
    stats: dict | None = None,
) -> np.ndarray:
    """Exact min-cost selection meeting the capped target, by the SSP on
    ``device``, named as for ``ssp_device_flows``; ``stats`` as there,
    plus ``buckets`` and the laps ``phases_s`` (``buckets``, ``ssp``,
    ``select``, seconds)."""
    r = len(start)
    if r == 0:
        return np.zeros(0, np.int64)
    if n >= INF:
        raise ValueError("genome length exceeds int32 device budget")
    t0 = time.perf_counter()
    with annotate("qmcp.buckets"):
        bs, be, off, pool, order, first = build_convex_buckets(start, end, cost)
    t1 = time.perf_counter()
    with annotate("qmcp.ssp"):
        flows = ssp_device_flows(bs, be, off, pool, first, n, max_coverage,
                                 device, stats)
    t2 = time.perf_counter()
    with annotate("qmcp.select"):
        counts = np.diff(off)
        rank = np.arange(r, dtype=np.int64) - np.repeat(off[:-1], counts)
        take = rank < np.repeat(flows, counts)
        out = np.sort(order[take]).astype(np.int64)
    if stats is not None:
        stats["buckets"] = int(bs.shape[0])
        stats["phases_s"] = {"buckets": t1 - t0, "ssp": t2 - t1,
                             "select": time.perf_counter() - t2}
    return out


class QmcpDeviceMcmfSolver(Solver):
    """Exact quality-weighted device solver (``qmcp-cuda``).

    Minimizes ``sum(max_quality - quality + 1)`` exactly, as ``qmcp-cpu``
    does. ``device`` is required: ``"cuda"`` launches the SSP kernel (and
    raises without a card), ``"cpu"`` runs its plain twin. Genomes longer
    than ``DEVICE_GENOME_LIMIT`` go to the host C++ MCMF; a device run
    that ends in a status other than ``OK`` raises ``SspStatusError``.
    ``last_stats`` says which engine ran (``engine``), with the phases,
    fixpoint rounds, buckets and laps (on the card also the kernel's own,
    ``ssp_device_flows``)."""

    uses_quality_of_reads = True

    def __init__(self, device: str | torch.device):
        self.device = resolve_device(device)
        self.last_stats: dict | None = None

    def solve(self, max_coverage: int, batch: ReadBatch) -> Solution:
        q = np.asarray(batch.quality, np.int64)
        cost = int(q.max(initial=0)) - q + 1
        n = batch.ref_genome_length
        stats = {"engine": "device", "phases": 0, "rounds": 0, "buckets": 0,
                 "device": str(self.device)}
        self.last_stats = stats
        if n > DEVICE_GENOME_LIMIT:
            _log.info("qmcp-cuda: genome %d > device limit %d; host MCMF engine",
                      n, DEVICE_GENOME_LIMIT)
            stats["engine"] = "host"
            t0 = time.perf_counter()
            with annotate("qmcp.host_mcmf"):
                out = mcmf_select_convex(batch.start, batch.end, cost, n,
                                         max_coverage)
            stats["phases_s"] = {"host": time.perf_counter() - t0}
            return out
        return ssp_device_select(
            np.asarray(batch.start, np.int64), np.asarray(batch.end, np.int64),
            cost, n, int(max_coverage), self.device, stats,
        )
