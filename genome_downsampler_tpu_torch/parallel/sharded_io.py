"""Host-sharded end-to-end downsampling: indexed BAM region reads per rank,
the mesh window solve, voffset-merged single-writer output.

Counterpart of the JAX package's ``parallel/sharded_io.py`` (the
chr1-scale multi-host pipeline, BASELINE.md config 5), one rank per
process over ``torch.distributed``. Per rank:

1. **Read a region, not the file.** Each rank looks up its genome window
   in the BAM index and reads ``[window_lo - halo, window_hi + halo]``
   (``io.bam.read_bam_region``; record ids are BGZF virtual offsets).
   ``halo`` must be at least the maximum read span PLUS the maximum mate
   start distance, or boundary pairs are dropped; a drop that touches the
   rank's window raises.
2. **Solve on the mesh.** The rank's rows and target (dense engine,
   ``parallel.mesh``) or packed codes (blocked engine,
   ``parallel.blocked_mesh``) are built from its region alone and the
   carry relaxation runs over the ranks, kernel A or B on the rank's
   device; bit-identical to the global sequential sweep.
3. **Reconstruct by end ownership** (``reconstruct_selection``): each end
   position belongs to one window, so ranks decide disjoint read sets with
   one global rule; the union equals the single-process selection.
4. **Merge and write once.** Selected voffsets (plus mates) are
   all-gathered; rank 0 re-streams the input over the sorted union.

Collectives ship tensors on ``RankMesh.wire``: the card under nccl (host
arrays are staged through it), the host under gloo. torch gathers int64
directly, so the JAX package's two-uint32-plane shipping is gone; the
per-rank lengths stay.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from genome_downsampler_tpu_torch import _native
from genome_downsampler_tpu_torch.config import BamApiConfig
from genome_downsampler_tpu_torch.io.bam import read_bam_region, write_bam
from genome_downsampler_tpu_torch.ops.coverage import (
    capped_coverage,
    coverage_from_intervals,
)
from genome_downsampler_tpu_torch.parallel.blocked_mesh import make_blocked_mesh_solver
from genome_downsampler_tpu_torch.parallel.launch import (
    RankMesh,
    global_window_mesh,
    shard_rows_globally,
)
from genome_downsampler_tpu_torch.parallel.mesh import make_mesh_solver
from genome_downsampler_tpu_torch.solvers.device_sweep import reconstruct_selection
from genome_downsampler_tpu_torch.utils.logging import get_logger

_log = get_logger("parallel.sharded")


class _Laps(dict):
    """Wall seconds by lap name, summed over repeats; a lap on the card
    ends by waiting for it."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device

    @contextlib.contextmanager
    def __call__(self, what: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self[what] = self.get(what, 0.0) + time.perf_counter() - t0


def bam_genome_length(path: Path | str) -> int:
    """First-contig length from the header only (hi = -1 stops the record
    scan immediately)."""
    cfg = BamApiConfig(min_mapq=0, min_seq_length=0)
    batch, _, _ = read_bam_region(path, cfg, 0, -1)
    return batch.ref_genome_length


def _blocked_window(n: int, w_total: int, block: int) -> int:
    """``pack_blocked``'s window: ``n / w_total`` rounded up to blocks."""
    return -(-(-(-n // w_total)) // block) * block


def _solve_blocked_on_mesh(
    mesh: RankMesh,
    start_local: np.ndarray,  # starts relative to the rank's window, in [0, local_n)
    end_local: np.ndarray,
    target_local: torch.Tensor,  # int32[local_n] on mesh.device
    local_n: int,
    win_b: int,
    w_local: int,
    block: int,
    max_span: int,
    stats: dict | None = None,
) -> torch.Tensor:
    """Blocked-engine mesh solve for the sharded pipeline: O(R/D) packed
    codes per rank. Returns ``sel_per_end`` (int32) for the rank's
    positions; ``stats`` receives the solver's ``last_stats``."""
    packed_l, counts_l, win_chk, _, _ = _native.pack_blocked(
        start_local, end_local, local_n, w_local, block, max_span
    )
    if win_chk != win_b:
        raise AssertionError((win_chk, win_b))
    nbw = packed_l.shape[0]

    # capacities agree across ranks: all-gather the max and pad with -1
    caps = mesh.all_gather(torch.tensor([packed_l.shape[2]], dtype=torch.int64))
    cap = int(torch.cat(caps).max())
    packed = torch.full((nbw, w_local, cap), -1, dtype=torch.int32, device=mesh.device)
    packed[:, :, : packed_l.shape[2]] = torch.from_numpy(packed_l)
    counts = torch.tensor(counts_l, device=mesh.device)

    fn = make_blocked_mesh_solver(
        mesh, nbw, cap, win_b, n_windows_local=w_local, block=block,
        max_span=max_span,
    )
    sel = fn(packed, counts, target_local.reshape(w_local, win_b))
    if stats is not None:
        stats.update(fn.last_stats)
    return sel.reshape(-1)


def solve_blocked_on_mesh(
    mesh: RankMesh,
    start: np.ndarray,
    end: np.ndarray,
    n: int,
    max_coverage: int,
    n_windows_local: int = 8,
    block: int = 256,
    max_span: int = 256,
    stats: dict | None = None,
) -> np.ndarray:
    """End-to-end blocked mesh solve (the blocked counterpart of
    ``parallel.mesh.solve_on_mesh``): each rank packs the given reads that
    start in its ``n_windows_local`` windows of ``pack_blocked``'s geometry
    over ``mesh.size * n_windows_local`` windows, builds their target, and
    relaxes; returns the global per-end counts (int32 ``[n_pad]``) on every
    rank."""
    win_b = _blocked_window(n, mesh.size * n_windows_local, block)
    local_n = n_windows_local * win_b
    lo = mesh.rank * local_n
    start = np.asarray(start, np.int64) - lo
    end = np.asarray(end, np.int64) - lo
    own = (start >= 0) & (start < local_n)
    target = capped_coverage(coverage_from_intervals(
        torch.as_tensor(start, device=mesh.device),
        torch.as_tensor(end, device=mesh.device), local_n,
    ), max_coverage).contiguous()
    sel = _solve_blocked_on_mesh(
        mesh, start[own], end[own], target, local_n, win_b, n_windows_local,
        block, max_span, stats,
    )
    return torch.cat(mesh.all_gather(sel)).cpu().numpy()


def _allgather_varlen_i64(mat: np.ndarray, mesh: RankMesh) -> list:
    """All-gather a per-rank ``(c, m)`` int64 matrix with rank-dependent
    ``m``. Returns one ``(c, m_p)`` matrix per rank."""
    c, m = mat.shape
    lens = [int(x) for x in torch.cat(
        mesh.all_gather(torch.tensor([m], dtype=torch.int64))).tolist()]
    cap = max(lens)
    if cap == 0:
        return [np.zeros((c, 0), np.int64) for _ in lens]
    pad = torch.zeros((c, cap), dtype=torch.int64)
    pad[:, :m] = torch.from_numpy(np.ascontiguousarray(mat, np.int64))
    parts = mesh.all_gather(pad)
    return [p[:, :n].cpu().numpy() for p, n in zip(parts, lens)]


QUALITY_ALGOS = ("qmcp-cpu", "qmcp-cuda", "qmcp-lp-cpu", "qmcp-sweep-cuda")


def run_sharded(
    path: Path | str,
    max_coverage: int,
    config: Optional[BamApiConfig] = None,
    out_path: Path | str | None = None,
    halo: int = 2_000,
    max_span: int = 256,
    engine: str = "auto",
    block: int = 256,
    windows_per_device: int = 8,
    algorithm: str = "mcp-cuda",
    allow_boundary_drops: bool = False,
    *,
    device: str | torch.device = "cuda",
    stats: dict | None = None,
) -> np.ndarray:
    """Sharded downsampling across all ranks of the process group (one rank
    without one), each rank's kernels on ``device``.

    Returns the merged selected+paired voffsets (all ranks); rank 0
    additionally writes ``out_path`` when given. Requires a
    coordinate-sorted input; uses ``<path>.bai`` when present. ``halo``
    must be at least max_span + the maximum mate start distance: a
    boundary drop of the region read that could touch the rank's window
    raises (``allow_boundary_drops`` downgrades it to a warning).

    ``algorithm``: an MCP name runs the exact sweep on the mesh (``engine``
    as below). A QMCP name (``QUALITY_ALGOS``) shards the BAM parse and
    filtering across ranks, all-reduces the GRADE MAPQ range so the
    quality remap is rank-invariant, gathers the truncated convex buckets
    of the reads each rank owns, and solves the exact bucket MCMF on the
    host, identically on every rank (as the JAX package does for every
    QMCP name).

    ``engine``: "dense" builds per-rank ``(win, L)`` rows; "blocked" packs
    O(R/D) codes into ``windows_per_device`` windows per rank; "auto" is
    dense while a rank's rows cost ``win * L * 4 <= 256 MiB``.

    ``stats``, when given, receives the engine, the solver's rounds and
    traffic and ``laps_s`` (read, pack, solve, reconstruct, gather, write;
    QMCP: read, pack, gather, solve, reconstruct, write)."""
    config = config or BamApiConfig()
    if halo < 2 * max_span:
        # the true requirement is max_span + max mate start distance, which
        # is unknowable here; 2*max_span is the weakest sane lower bound
        raise ValueError(
            f"halo {halo} must be >= 2 * max_span = {2 * max_span} "
            "(and >= max_span + max mate start distance)"
        )
    stats = {} if stats is None else stats
    n = bam_genome_length(path)
    mesh = global_window_mesh(device)
    laps = _Laps(mesh.device)
    n_dev = mesh.size
    if engine == "auto":
        # dense rows for a rank's window cost win * L * 4 bytes
        engine = (
            "dense"
            if (-(-n // n_dev)) * max_span * 4 <= 256 * 1024 * 1024
            else "blocked"
        )
    if engine == "blocked":
        w_total = n_dev * windows_per_device
        win_b = _blocked_window(n, w_total, block)
        if win_b < max_span:
            raise ValueError(
                f"blocked window {win_b} < max_span {max_span}; lower "
                "windows_per_device"
            )
        win = windows_per_device * win_b  # per-rank span
        n_pad = w_total * win_b
    else:
        win = max(-(-n // n_dev), max_span)
        n_pad = win * n_dev

    # this rank's windows form one contiguous range
    lo_w, hi_w = mesh.rank * win, (mesh.rank + 1) * win  # [lo_w, hi_w)
    lo = max(0, lo_w - halo)
    hi = min(n_pad, hi_w + halo) - 1
    with laps("read"):
        region = read_bam_region(path, config, lo, hi, defer_grade=True)
    batch = region.batch
    _log.debug(
        "rank %d: windows [%d, %d), region [%d, %d], %d reads",
        mesh.rank, lo_w, hi_w, lo, hi, batch.n_reads,
    )

    # Halo-contract enforcement: a read whose mapped same-contig mate fell
    # outside [lo, hi] was dropped by the pairing scan. If either record of
    # such a pair could touch this rank's owned window, the sharded output
    # would diverge from a single-process run.
    if region.unmatched.shape[0]:
        us, ue, ump = (region.unmatched[:, k] for k in range(3))
        touches = ((ue >= lo_w) & (us < hi_w)) | (
            (ump >= lo_w - max_span) & (ump < hi_w)
        )
        n_bad = int(touches.sum())
        if n_bad:
            worst = int(
                np.max(np.abs(us[touches] - ump[touches])) + max_span
            )
            msg = (
                f"rank {mesh.rank}: {n_bad} boundary pair(s) "
                f"dropped by the region read touch the owned window "
                f"[{lo_w}, {hi_w}); halo={halo} is too small — the widest "
                f"offending pair needs >= {worst}"
            )
            if not allow_boundary_drops:
                raise RuntimeError(msg)
            _log.warning("%s (allow_boundary_drops=True: continuing)", msg)

    # GRADE must be rank-invariant: all-reduce the MAPQ range before the
    # quality remap (region-local min/max would diverge)
    if config.amplicon_behaviour.name == "GRADE" and config.bed_path:
        mapq = np.array(
            [
                -(region.min_mapq_seen if region.max_mapq_seen >= 0
                  else 2**31),
                region.max_mapq_seen,
            ],
            np.int64,
        )
        gathered = _allgather_varlen_i64(mapq.reshape(2, 1), mesh)
        allv = np.concatenate([g.reshape(2, -1) for g in gathered], axis=1)
        gmin, gmax = int(-allv[0].max()), int(allv[1].max())
        if gmax >= 0 and gmin < 2**31:
            batch.quality = (
                batch.quality - gmin
                + np.where(region.in_single, gmax - gmin, 0)
            ).astype(np.int32)

    start = np.asarray(batch.start, np.int64)
    end = np.asarray(batch.end, np.int64)
    span = end - start + 1
    if span.size and int(span.max()) > max_span:
        raise ValueError(
            f"read span {int(span.max())} exceeds max_span={max_span}"
        )

    stats.update(engine="qmcp" if algorithm in QUALITY_ALGOS else engine,
                 ranks=n_dev, rank=mesh.rank, reads=int(batch.n_reads),
                 laps_s=laps)
    if algorithm in QUALITY_ALGOS:
        return _run_sharded_qmcp(
            batch, n, max_coverage, lo_w, hi_w, path, out_path, config, mesh, laps
        )

    local_n = hi_w - lo_w
    in_win = (start >= lo_w) & (start < hi_w)
    with laps("pack"):
        if engine == "blocked":
            target_local = capped_coverage(coverage_from_intervals(
                torch.as_tensor(start - lo_w, device=mesh.device),
                torch.as_tensor(end - lo_w, device=mesh.device), local_n,
            ), max_coverage).contiguous()
        else:
            rows_local, target_local = shard_rows_globally(
                start, end, mesh, win, max_coverage, max_span
            )
    with laps("solve"):
        if engine == "blocked":
            sel_local = _solve_blocked_on_mesh(
                mesh, start[in_win] - lo_w, end[in_win] - lo_w, target_local,
                local_n, win_b, windows_per_device, block, max_span, stats,
            )
        else:
            fn = make_mesh_solver(mesh, n_pad, max_span)
            sel_local = fn(rows_local, target_local)
            stats.update(fn.last_stats)

    with laps("reconstruct"):
        sel_reads = _reconstruct_owned(
            start, end, lo_w, hi_w, sel_local.cpu().numpy().astype(np.int64), max_span
        )
        paired = batch.find_pairs(sel_reads)
        voffs_local = np.asarray(batch.bam_id[paired], np.int64)
    return _merge_and_write(voffs_local, path, out_path, config, mesh, laps)


def _reconstruct_owned(start, end, lo_w, hi_w, sel_local, max_span) -> np.ndarray:
    """Indices of the reads that end ownership selects: among the reads whose
    END lies in ``[lo_w, hi_w)``, the first ``sel_local[e - lo_w]`` of each
    end bucket by (start, index).

    The frame begins ``max_span`` before the window, so no owned read's
    start is negative there: the host C reconstruct, which
    ``reconstruct_selection`` takes from 200,000 reads on, refuses negative
    starts (the JAX package reconstructs in window coordinates and raises
    there on every rank but 0). A shift leaves every bucket's order as it
    is."""
    own = np.flatnonzero((end >= lo_w) & (end < hi_w))
    base = max(lo_w - max_span, 0)
    quota = np.concatenate([np.zeros(lo_w - base, np.int64), sel_local])
    return own[reconstruct_selection(start[own] - base, end[own] - base, quota)]


def _merge_voffsets(voffs_local: np.ndarray, mesh: RankMesh) -> np.ndarray:
    """All-gather every rank's selected voffsets and return the sorted
    union."""
    parts = _allgather_varlen_i64(voffs_local.reshape(1, -1), mesh)
    return np.unique(np.concatenate([p.reshape(-1) for p in parts]))


def _merge_and_write(voffs_local, path, out_path, config, mesh: RankMesh,
                     laps: _Laps) -> np.ndarray:
    with laps("gather"):
        merged = _merge_voffsets(np.asarray(voffs_local, np.int64), mesh)
    with laps("write"):
        if out_path is not None and mesh.rank == 0:
            write_bam(
                path, out_path, merged, config.hts_thread_count,
                ids_are_voffsets=True,
            )
    return merged


LAST_QMCP_STATS: dict = {}


def _run_sharded_qmcp(
    batch, n, max_coverage, lo_w, hi_w, path, out_path, config,
    mesh: RankMesh, laps: _Laps,
) -> np.ndarray:
    """Exact weighted QMCP in sharded mode: distributed parse, partitioned
    bucket build, truncated-pool gather, replicated bucket solve on the
    host (the JAX package's ``_run_sharded_qmcp``; its docstring states the
    exactness contract: objective-exact against a single-process
    ``qmcp-cpu`` run, and the read set equal unless equal-cost ties span
    different buckets).

    Every read is owned by the rank whose window contains its START, so
    every convex bucket (a distinct (start, end)) lives wholly on one rank.
    Each rank builds its buckets in the whole-file emission order, keeps
    every pool's cheapest ``min(count, M)`` units, and all-gathers only
    (bucket spans, truncated costs). The bucket MCMF runs identically on
    every rank; each rank expands only its own buckets' flows to reads."""
    from genome_downsampler_tpu_torch.solvers.device_mcmf import build_convex_buckets
    from genome_downsampler_tpu_torch.solvers.native_mcmf import mcmf_flows_convex

    with laps("pack"):
        start = np.asarray(batch.start, np.int64)
        end = np.asarray(batch.end, np.int64)
        q = np.asarray(batch.quality, np.int64)
        voff = np.asarray(batch.bam_id, np.int64)
        # a whole-file import emits each pair at its SECOND mate's record,
        # first mate first: key = (max voffset of the pair, mate rank);
        # mates are locally adjacent (index ^ 1)
        pairmax = np.maximum(voff, voff[np.arange(voff.shape[0]) ^ 1])
        rank2 = (~np.asarray(batch.is_first, bool)).astype(np.int64)
        own = np.flatnonzero((start >= lo_w) & (start < hi_w))
        own = own[np.lexsort((rank2[own], pairmax[own]))]  # emission order

    with laps("gather"):
        # the whole file's max quality for the cost map
        q_max_local = np.array([[q[own].max() if len(own) else 0]], np.int64)
        q_max = max(int(p[0, 0]) for p in _allgather_varlen_i64(q_max_local, mesh))
    with laps("pack"):
        cost = q_max - q[own] + 1
        bs, be, off, pool, border, _first = build_convex_buckets(
            start[own], end[own], cost
        )
        nb = bs.shape[0]
        cnts = np.diff(off)
        keepn = np.minimum(cnts, int(max_coverage))
        rank_in = np.arange(len(pool), dtype=np.int64) - np.repeat(off[:-1], cnts)
        pool_t = pool[rank_in < np.repeat(keepn, cnts)]

        # 2 int64 columns per bucket: start, and (span << 20 | kept units);
        # keepn needs 20 bits, span the remaining 43 — a silent overflow
        # would corrupt spans and pool offsets on the gathering ranks
        if int(max_coverage) >= 1 << 20:
            raise ValueError(
                f"sharded qmcp: max_coverage {max_coverage} >= 2^20 overflows "
                "the packed bucket metadata; use single-process mode"
            )
        span_all = be - bs + 1
        if len(span_all) and int(span_all.max()) >= 1 << 42:
            raise ValueError("sharded qmcp: bucket span overflows metadata")
        packed_meta = (span_all << 20) | keepn.astype(np.int64)
        meta = np.concatenate([np.array([nb], np.int64), bs, packed_meta]).reshape(1, -1)
    with laps("gather"):
        mparts = _allgather_varlen_i64(meta, mesh)
        pparts = _allgather_varlen_i64(pool_t.reshape(1, -1), mesh)
        tot_reads = sum(
            int(p.reshape(-1)[0])
            for p in _allgather_varlen_i64(np.array([[len(own)]], np.int64), mesh)
        )

    with laps("solve"):
        gbs, gbe, gkeep = [], [], []
        for p in mparts:
            row = p.reshape(-1)
            b_k = int(row[0])
            pbs = row[1 : 1 + b_k]
            pm = row[1 + b_k : 1 + 2 * b_k]
            gbs.append(pbs)
            gbe.append(pbs + (pm >> 20) - 1)
            gkeep.append(pm & ((1 << 20) - 1))
        my_b0 = int(sum(len(x) for x in gbs[: mesh.rank]))
        gbs_c = np.concatenate(gbs)
        gbe_c = np.concatenate(gbe)
        gkeep_c = np.concatenate(gkeep)
        goff = np.zeros(len(gbs_c) + 1, np.int64)
        np.cumsum(gkeep_c, out=goff[1:])
        gpool = np.concatenate([p.reshape(-1) for p in pparts])

        # ranks own ascending start windows and each local bucket list is
        # (start, end)-sorted, so the concatenation is the bucket sequence
        # a whole-file build produces
        flows = mcmf_flows_convex(gbs_c, gbe_c, goff, gpool, int(n), int(max_coverage))
    global LAST_QMCP_STATS
    LAST_QMCP_STATS = {
        # what this rank holds of remote data vs replicating (start, end,
        # quality, voffset, pair, rank) int64 tuples for every read
        "gathered_bytes": int((2 * len(gbs_c) + len(gpool)) * 8),
        "replicated_tuple_bytes_r3": int(6 * 8 * tot_reads),
        "buckets": int(len(gbs_c)),
        "pool_units": int(len(gpool)),
        "total_reads": int(tot_reads),
    }

    with laps("reconstruct"):
        my_flows = flows[my_b0 : my_b0 + nb]
        take = rank_in < np.repeat(my_flows, cnts)
        mine_idx = own[border[take]]
        paired = batch.find_pairs(np.sort(mine_idx))
        voffs_local = np.asarray(batch.bam_id[paired], np.int64)
    return _merge_and_write(voffs_local, path, out_path, config, mesh, laps)
