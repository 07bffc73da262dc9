#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit (``nvcc``). It imports nothing of JAX and nothing of the JAX
package. Phases, each of which raises on failure:

1. probe: the card (``nvidia-smi`` name and power limit), torch / CUDA
   versions; build the kernels from ``genome_downsampler_tpu_torch/ops/
   csrc`` (one ``nvcc`` per source, in parallel) and report the build time;
2. kernel B (blocked sweep) == its plain torch twin on the card, on a small
   geometry, on long reads at L=768 (W=4, B=128: two chunks a block) and on
   the config-4 solve's own packed codes (W=32, B=128, L=256), with and
   without auto_target, a grid offset and seeded carries; time one full
   config-4 pass (ns per position beside its bound) and the kernel vs the
   twin on a tail slice;
3. kernel C (selection) == its twin == the argsort engine, at config-4;
4. the main path at config-4 scale (10M reads of 150 bp, uniform starts
   over 5 Mb, M=50: 300x -> 50x) through ``default_registry().get(
   "mcp-cuda")``, which dispatches to the blocked engine there: read set
   equal to ``mcp-cpu`` (the host C++ greedy), coverage valid at every
   base, kernels B and C launched and kernel A not; phase laps and the warm
   end-to-end time beside the host greedy's;
5. CLI BAM -> BAM (200k reads over 30 kb, M=100: the dense engine) with
   ``-a mcp-cuda``, ``-a mcp-cuda --windows 4`` and ``-a mcp-cpu``: the same
   records;
6. kernel A (dense sweep) == its twin: small shapes (S in {1, 4}, L=64,
   n=4096, zero and seeded carries, takes off and on), config-1 (a
   uniform-start stand-in at BASELINE config 0's size: 50k reads over
   29,903 bases, M=100; takes off and on) and the deep 30 kb cell (1M reads
   over 29,903 bases, M=1000: the first 4096 positions); kernel and twin
   times;
7. the dense main path through ``mcp-cuda`` at config-1, the deep 30 kb cell
   and the dense engine's edge (2M reads over 262,144 bases, rows of
   exactly 256 MiB, M=50): read set equal to ``mcp-cpu``, coverage valid,
   kernel A launched and B and C not; warm solve times beside ``mcp-cpu``;
8. ``WindowedMcpSolver("cuda", n_windows=32)`` on the config-4 batch
   (5.1 GB of rows on the card): read set equal to ``mcp-cpu``; the rounds;
   the warm solve time;
9. ``solve_batch`` over 8 config-1-size samples in one kernel A launch:
   each read set equal to ``mcp-cpu`` on its sample;
10. ``qmcp-sweep-cuda`` at config-1: read set equal to the CPU twin
    solver's, count equal to ``mcp-cpu``'s, total MAPQ >= ``mcp-cuda``'s,
    coverage valid;
11. kernel A's variants C and B through ``python -m
    genome_downsampler_tpu_torch.scripts.kernel_variants``'s ``run`` at its
    default size (1M pairs, 2M reads, over 30,000 bases, n=30,208, L=256,
    M=1000): each equal to kernel A and to the port's ``sweep_counts`` over
    the whole row, and to its twin on the first 4,096 positions; kernel A,
    C and B times side by side (all three on one frame: a sweep warp and
    three producer warps), ns per position on the whole row and the
    differences A - C and C - B, and the twins'; each instantiation's
    registers and local (spill) bytes as the built kernels report them;
12. the blocked sweep's ablation: all seven modes equal to their twin at
    W=4, B=128, L=64; ``full`` equal to kernel A over the 64 whole window
    rows at 1M reads over 2.5 Mb (S=64, 2.6 GB of rows); the seven modes
    timed through ``scripts.bench_kernel_ablate``'s ``run`` at its default
    (6M reads, W=64, B=128, L=256), ``full`` there equal to kernel B on the
    same codes (targets given, zero carries) and timed beside it in turns,
    the step's pieces in ns per step (take, shift, emit, fold, handover:
    differences of the modes), each mode equal to its twin on the first
    blocks of that default, each instantiation's registers and spills (the
    ablation runs on kernel B's frame, so its modes price kernel B's step);
13. the SSP kernel (``qmcp-cuda``'s whole solve, one cooperative launch
    of up to one CTA per SM) == its twin in flows, supply, status, phases
    and rounds on the six seeded inputs of the JAX suite's random LP cases
    (N=600), the card tests' four CTA-boundary cases (ragged and small
    chunks, spans up to 1,000, stacked amplicons), the 3,000-base cut of
    config-1 (2,508 pairs, M=100) and config-1 itself (117 CTAs), status
    OK; timed on config-1, the cut and the QMCP edge;
14. ``qmcp-cuda`` through the registry against ``qmcp-cpu`` (the host C++
    MCMF), each warmed on other data: config-1, 32,768 and 65,536 bases and
    the device limit's edge at config-1's depth (109,583 pairs over 131,072
    bases), total cost
    equal, coverage valid, ``engine == "device"``, one SSP launch a solve; a 262,144-base genome goes to the host engine;
15. the profiler (``utils.profiling.trace``) around one warm config-4
    ``mcp-cuda`` solve and one warm config-1 ``qmcp-cuda`` solve: the
    device's busy share of the traced window and device time per kernel;
    the traces under ``build/profile/``.
16. ``quasi-mcp-flow-cuda`` (push-relabel max-flow as torch ops on the
    card; no hand kernel yet) through the registry, warm, beside
    ``mcp-cpu``: at the 3,000-base cut and config-1 the read set and the
    supersteps equal the same solver's run on the CPU; at the reference's
    largest workload (1M pairs over 30,000 bases, M=1000) coverage valid
    and fewer reads than given; per cell the supersteps, global relabels,
    closure rounds and host syncs, ms a superstep beside its bound (28
    bytes an arc: the table's five int32 columns and two label gathers)
    and the laps; the device's busy share of one traced cut solve
    (``build/profile/flow/``); all also as one ``{"push_relabel": ...}``
    JSON line;
17. the mesh engines and ``--sharded`` (``parallel/``, over
    ``torch.distributed``): (a) one rank over NCCL in this process: the
    blocked mesh at config-4 (W_local=32, B=128, L=256), its read set
    equal to ``mcp-cpu``'s, coverage valid, one kernel B launch a round,
    timed beside ``mcp-cuda``'s blocked engine; the dense mesh at config-1
    and the edge, ``sel`` equal to kernel A over the whole genome in one
    launch; (b) two ranks on the one card over gloo (``python -m``
    workers, ``testing.mesh_worker``): ``entry.dryrun_multichip`` at L=32
    and the config-4 blocked mesh as 2 x 16 windows, ``sel`` equal to (a);
    rounds, messages, bytes over the wire and across PCIe, host syncs; (c)
    the CLI BAM -> BAM on 6M reads over 3 Mb (config-4's 300x depth, M=50)
    laid out as pairs at most 600 bases apart (indexed with
    ``write_bai``): ``-a mcp-cuda --sharded`` at
    1 and 2 processes byte-equal to ``-a mcp-cuda`` and ``-a mcp-cpu``, and
    ``-a qmcp-cuda --sharded`` at 2 processes equal to 1 on 200,000 such
    reads over 30,000 bases (M=100), each run's wall time and the laps it
    logs (read, pack, solve, reconstruct, gather, write); all also as one
    ``{"sharded": ...}`` JSON line. Kernels A's and B's entries carry the
    launches of (a) as ``sharded_launches``.

Phase 3b holds kernel B's wide path (``blocked_sweep_wide.cu``: long
reads at L=1,024 and 4,096, from zero and seeded carries, timed; 70,000
reads starting at one position; the config-4 full pass at L=256 called
through the wide path, equal to the register path and timed beside it) and
kernel C's run-time-L instantiation (L=1,024 and 4,096) to their twins.
Phase 3c is the wide path's main path: ``mcp-cuda-blocked`` warm against
``mcp-cpu`` on the three read sets of ``testing/long_reads.py`` from seed
12345, ``midnight-30kb`` (200,000 tiled 1,200-bp amplicon reads over 29,903
bases, M=100: W=8, B=256, L=1,280), ``long-5mb`` (250,000 reads of
1,000-3,000 bases over 5 Mb, M=50: W=64, B=128, L=3,072) and
``artic-deep-30kb`` (7M pairs of 100-150 bp on 98 ARTIC amplicons, 71,428
first mates starting at each primer site, M=1000: W=8, B=256, L=256, every
pass on the wide path for its depth): read set equal, coverage valid, the
wide path and kernel C launched and the register path not; the laps and
rounds; on the solve's own last kernel C arguments, one full pass of the
wide path and kernel C each held to its twin and timed (ns per position).

Each path is driven with every launch count set to 0 just before it and
read just after; each phase prints its wall time. Phases 7-9 also record
the arguments of the path's last kernel A launch and hold the kernel
against its twin on them (the head of every row from the path's own
carries; for the windows also the tail, at the highest addresses of the
5.1 GB of rows), and time the kernel on the whole launch. Kernel times
are CUDA events, the least of the timed launches after a warm one
(``scripts.best_ms``); a twin is timed once. Integer results
must match exactly (tolerance 0). Each kernel's ``bound_ms`` is computed
from the inputs it was timed on (``bound``: bytes read and written once
over the memory rate, or int32 operations over the int32 rate, the
larger); no single PyTorch call computes any of them, so ``library_ms`` is
null. The output ends with three lines: a JSON object with one entry per
kernel, the card's name and power limit, and
``{"ok": true, "device": {"platform": "gpu", ...}}``. Exits non-zero,
printing neither line, without a CUDA device or outside the repository.

    python3 chip_smoke.py --against OTHER.cu [--against OTHER2.cu ...]

holds a kernel against another version of its source (an earlier
commit's, written out with ``git show <commit>:genome_downsampler_tpu_torch/
ops/csrc/dense_sweep.cu``): the kernel is the one whose C entries the other
source defines (``gd_dense_sweep``: kernel A, ``gd_blocked_sweep``: kernel
B, ``gd_blocked_sweep_wide``: kernel B's wide path, ``gd_blocked_select``:
kernel C, ``gd_ssp_solve``: the SSP kernel, whose one-CTA version's entry
is also taken; ``gd_sweep_variant_c`` and ``gd_sweep_variant_b`` together:
the variants, one kernel of two entries; ``gd_blocked_ablate``: the
ablation; the wide path's earlier entry, with an extra ``wide_tile``, is
also taken). Each other source is built into its
own library under ``build/against/``, and the port's source of the same
kernel compiled beside it, all with ``-Xptxas -v`` (registers and spills
per instantiation are printed). Phases 1 and 2 run, then each version is
held bit-equal to the port's and the two are timed in turns (other, port,
port, other) at its kernel's cells: kernel A at config-1 (counts and takes
mode), the edge and 32 rows of 32,768 positions at config-4's depth;
kernel B on the config-4 full pass and tail slice; the wide path on phase
3b's passes at L=1,024 and 4,096 and its deep stack (also from seeded
carries at grid offset 1), one full pass of each read set of phase 3c and
the config-4 full pass; kernel C on the config-4 full pass; the SSP kernel on
the 3,000-base cut, config-1 and the QMCP edge
(once a turn there); the variants, C and B each, on the kernel_variants
default row (n=30,208, L=256), its first 4,096 positions and an L=64 row,
where the port's are first held to kernel A; the ablation, all seven modes,
on the bench_kernel_ablate default (checked on its first 4 blocks and on
phase 12's W=4, L=64 case). It ends with the turns' JSON
object instead of the three lines.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 12345
C4_READS, C4_GENOME, C4_M, READ_LEN = 10_000_000, 5_000_000, 50, 150
TAIL_BLOCKS = 4  # blocks per window the plain sweep twin is timed on
# (pairs, genome, M) of the dense engine's cells, uniform read starts:
# stand-ins at the size of BASELINE config 0 (a SARS-CoV-2 amplicon BAM) and
# deep (1M reads over 29,903 bases, M=1000: half the read depth of
# scripts/kernel_variants.py, 1M pairs or 2M reads over 30,000 bases, which
# phase 11 runs), and the dense/blocked edge (rows of 256 MiB)
C1 = (25_000, 29_903, 100)
DEEP = (500_000, 29_903, 1000)
EDGE = (1_000_000, 262_144, 50)
DEEP_CHECK = 4096  # positions per row the plain twin checks (S <= 8)
WIN_CHECK = 2048  # positions per window row the twin checks, head and tail
WINDOWS = 32
# where --against builds the other versions (git-ignored)
AGAINST_DIR = ROOT / "build" / "against"
DENSE_ROWS = 32_768  # positions per row of --against's S=32 cell of kernel A
# bound_ms: the card's peaks (NVIDIA H100 SXM data sheet; the int32 rate
# from the Hopper white paper: 64 int32 lanes per SM, 132 SMs, 1.98 GHz
# boost clock); every kernel here is integer work
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 ops per ring slot per position of the sweep step (kernels A and B,
# the variants, the ablation): the arrival add, deficit - G, the clip's max
# and min, F - G, the selend add, min(taken, F) and F -= (G, the next slot's
# F, is a register read or a shuffle, not arithmetic)
SWEEP_OPS = 8
# int32 ops of the wide path's per-end step (blocked_sweep_wide.cu): per
# position and window the deficit, its clamp, the take's min, the emit, cur,
# A, the slot's clear and h; per read its end slot, the wrap, its count and
# live bit at arrival, and its count's one take or expiry (a walk step that
# empties a slot, or the slot's clear, is paid once per read that filled it)
WIDE_POSITION_OPS, WIDE_READ_OPS = 8, 6
# the read sets of phase 3c, the wide path's main path (testing/long_reads.py),
# and their M
WIDE_READ_SETS = {"midnight-30kb": ("midnight_30kb", 100), "long-5mb": ("long_5mb", 50),
                  "artic-deep-30kb": ("artic_deep_30kb", 1000)}
# per selected-or-not read of kernel C: its start and end from the code,
# the bucket's rank offset, the quota gather, the compare, the store
SELECT_OPS = 8
# the SSP kernel, per fixpoint round: d, pk, pid, pi over the n + 1 nodes
# and flow, cap, off0, bstart, bend1, pool over the B buckets, 4 bytes
# each, moved once; 8 int32 operations per node and per bucket side
SSP_NODE_ARRAYS, SSP_BUCKET_ARRAYS, SSP_OPS = 4, 6, 8
# qmcp cells (pairs of 150 bp reads, genome, M): the 3,000-base cut of
# config-1 the SSP kernel is timed on, 32,768 and 65,536 bases (where
# qmcp-cuda and qmcp-cpu cross), the device limit's edge and a genome above
# it, all at config-1's depth
SSP_CUT = (2_508, 3_000, 100)
QMCP_32K = (27_395, 32_768, 100)
QMCP_64K = (54_791, 65_536, 100)
QMCP_EDGE = (109_583, 131_072, 100)
QMCP_HOST = (219_166, 262_144, 100)
PROFILE_DIR = ROOT / "build" / "profile"
# quasi-mcp-flow-cuda's cells (pairs of 150 bp reads, genome, M): the
# 3,000-base cut and config-1, held to the same solver on the CPU, and the
# reference's largest workload (1M pairs over 30 kb, M=1000, its
# coverage_tester's biggest; the JAX suite's test_reference_largest_workload_scale)
FLOW_LARGEST = (1_000_000, 30_000, 1000)
# bytes a superstep moves at the least: one read of the arc table's five
# int32 columns and the two label gathers, 4 bytes each, per arc; a round
# of the distance closure: d read and written once (8 bytes a line node),
# each read's start and end + 1 (int32) and its two residual flags (bool)
# read once (10 bytes a padded read); the arc table's build: start and end
# read once, the five int32 columns written once
FLOW_BYTES_PER_ARC = 28
FLOW_ROUND_BYTES_PER_NODE, FLOW_ROUND_BYTES_PER_READ = 8, 10
FLOW_TABLE_BYTES_PER_READ, FLOW_TABLE_BYTES_PER_ARC = 8, 20
# phase 17: the blocked mesh's windows a rank and block at config-4 (one
# rank: kernel B's config-4 geometry), the CLI cells (pairs of 150 bp reads,
# genome, M; mates at most MAX_INSERT bases apart): config-4's depth (300x)
# cut to 6M reads over 3 Mb, which keeps phase 17 near 150 s (at 10M reads
# over 5 Mb it took 163.5 s), and phase 5's size for qmcp-cuda
SHARDED_W_LOCAL, SHARDED_BLOCK = 32, 128
SHARDED_CLI = (3_000_000, 3_000_000, C4_M)
SHARDED_QMCP = (100_000, 30_000, 100)
MAX_INSERT = 600
# gd_blocked_sweep_wide as its earlier sources declared it:
# gd_blocked_sweep's arguments, then wide_tile
WIDE_TILE_SIGNATURE = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 9 + [ctypes.c_void_p]


def log(*a):
    print(*a, flush=True)


def bound(ops, nbytes):
    """``(bound_ms, bound_by)``: the larger of the bytes over the memory
    rate and the int32 operations over the int32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sweep_bound(codes, W, positions, L, extra_bytes):
    """Kernel B's (or the ablation's) bound: each code read once, the
    emitted counts and the carries written once, SWEEP_OPS per slot."""
    nbytes = 4 * (codes + W * positions + 6 * W * L) + extra_bytes
    return bound(SWEEP_OPS * W * positions * L, nbytes)


def launch_counts():
    """Each kernel's wrapper, which carries its launch count."""
    from genome_downsampler_tpu_torch.ops import ablate, blocked, ssp, sweep, variants

    return {
        "dense_sweep": sweep.dense_sweep_counts,
        "blocked_sweep": blocked.blocked_sweep_pass,
        "blocked_sweep_wide": blocked.blocked_sweep_wide,
        "blocked_select": blocked.blocked_selection_pass,
        "variant_c": variants.sweep_variant_c,
        "variant_b": variants.sweep_variant_b,
        "ablate": ablate.blocked_ablate,
        "ssp": ssp.ssp_solve,
    }


def reset_launches():
    for fn in launch_counts().values():
        fn.launches = 0


def read_launches():
    return {k: fn.launches for k, fn in launch_counts().items()}


def expect_launches(got, *launched):
    """Every kernel in ``launched`` ran at least once, no other did."""
    bad = {k: v for k, v in got.items() if (v >= 1) != (k in launched)}
    if bad:
        raise AssertionError(f"launches {got}: expected only {launched} to run")


def max_abs_err(got, ref) -> int:
    """Largest |kernel - twin| over paired integer tensors; raises unless 0."""
    err = 0
    for g, r in zip(got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"shape/dtype {g.shape}/{g.dtype} vs {r.shape}/{r.dtype}")
        if g.numel():
            err = max(err, int((g.long() - r.long()).abs().max()))
    if err != 0:
        raise AssertionError(f"kernel differs from its plain twin (max |err| {err})")
    return err


def config4_batch():
    import numpy as np

    from genome_downsampler_tpu_torch.core.readbatch import ReadBatch

    rng = np.random.default_rng(SEED)
    starts = rng.integers(0, C4_GENOME - READ_LEN, C4_READS, dtype=np.int64)
    return ReadBatch(
        bam_id=np.arange(C4_READS, dtype=np.int64),
        start=starts,
        end=starts + READ_LEN - 1,
        quality=np.full(C4_READS, 60, np.int32),
        seq_length=np.full(C4_READS, READ_LEN, np.int32),
        is_first=np.tile([True, False], C4_READS // 2),
        ref_genome_length=C4_GENOME,
    )


def config4_inputs(dev, batch):
    """The config-4 solve's packed codes, counts, target and cross-window
    offsets on the card, at the blocked solver's geometry."""
    import numpy as np
    import torch

    from genome_downsampler_tpu_torch import _native
    from genome_downsampler_tpu_torch.ops import blocked
    from genome_downsampler_tpu_torch.solvers.blocked_sweep import (
        BlockedWindowedMcpSolver,
        _cross_window_offsets,
    )

    W, B, L, chunk = BlockedWindowedMcpSolver("cuda")._geometry(
        C4_GENOME, READ_LEN, C4_READS * READ_LEN / C4_GENOME
    )
    flat, counts, win, n_pad, cap, _ = _native.pack_flat_direct(
        batch.start, batch.end, C4_GENOME, W, B, L, cap_multiple=chunk,
        cap_floor=2 * chunk,
    )
    counts_d = torch.tensor(counts, device=dev)
    return {
        "W": W, "B": B, "L": L, "win": win, "counts": counts_d,
        "p32": blocked.expand_flat_codes(
            torch.tensor(flat.view(np.int16), device=dev), counts_d, win // B, W, cap
        ),
        "target": torch.tensor(
            _native.capped_target(batch.start, batch.end, n_pad, C4_M).reshape(W, win),
            device=dev,
        ),
        "xwin": torch.tensor(
            _cross_window_offsets(batch.start, batch.end, win, W, B, L), device=dev
        ),
    }


def phase_sweep(dev, c4, report):
    """Kernel B against its twin; returns the kernel's JSON entry."""
    import numpy as np
    import torch

    from genome_downsampler_tpu_torch.testing.reads_gen import rand_reads_uniform
    from genome_downsampler_tpu_torch import _native
    from genome_downsampler_tpu_torch.ops import blocked
    from genome_downsampler_tpu_torch.scripts import best_ms

    errs = []
    # small geometry (the CPU tests' W=4, B=64, L=64)
    rng = np.random.default_rng(SEED)
    b = rand_reads_uniform(rng, 800, 900, 48)
    packed, counts, win, n_pad, _ = _native.pack_blocked(
        b.start, b.end, 900, 4, 64, 64, cap_multiple=64
    )
    small = (torch.tensor(packed, device=dev), torch.tensor(counts, device=dev),
             torch.tensor(_native.capped_target(b.start, b.end, n_pad, 5).reshape(4, win),
                          device=dev), 4, 64, 64)
    cases = [(small, False, 0, False), (small, True, 0, False),
             (small, True, 2, True), (small, False, 1, True)]
    # long reads at the largest L (spans up to 700 bp, W=4, B=128, L=768:
    # the kernel cuts each block in two chunks of 64 positions)
    n = 4 * 6 * 128
    start = np.sort(rng.integers(0, n - 768, 2 * n))
    end = start + rng.integers(0, 700, 2 * n)
    packed, counts, win, n_pad, _ = _native.pack_blocked(start, end, n, 4, 128, 768,
                                                         cap_multiple=128)
    long_ = (torch.tensor(packed, device=dev), torch.tensor(counts, device=dev),
             torch.tensor(_native.capped_target(start, end, n_pad, 40).reshape(4, win),
                          device=dev), 4, 128, 768)
    cases += [(long_, True, 0, False), (long_, False, 2, True), (long_, True, 1, True)]
    # config-4: the solve's own packed codes
    p32, cnt, tgt4, W, B, L = c4["p32"], c4["counts"], c4["target"], c4["W"], c4["B"], c4["L"]
    nbw = p32.shape[0]
    tail = nbw - TAIL_BLOCKS
    big = (p32, cnt, tgt4, W, B, L)
    cases += [(big, True, tail, False), (big, False, tail, True),
              (big, True, tail, True)]
    for (p, c, tgt, w, bb, ll), auto, off, seeded in cases:
        g = torch.Generator().manual_seed(SEED)
        carries = [
            (torch.randint(0, 4, (w, ll), generator=g, dtype=torch.int32) if seeded
             else torch.zeros((w, ll), dtype=torch.int32)).to(dev)
            for _ in range(3)
        ]
        kw = dict(grid_offset=off, avail0i=carries[2], auto_target=auto,
                  max_coverage=C4_M if auto else 0)
        t = None if auto else tgt
        got = blocked.blocked_sweep_pass(p, c, t, carries[0], carries[1], w, bb, ll, **kw)
        torch.cuda.synchronize()
        ref = blocked.blocked_sweep_pass_plain(p, c, t, carries[0], carries[1], w, bb, ll, **kw)
        errs.append(max_abs_err(got, ref))
        log(f"  kernel B == plain: W={w} B={bb} L={ll} auto_target={auto} "
            f"grid_offset={off} seeded={seeded}")

    z = torch.zeros((W, L), dtype=torch.int32, device=dev)
    kw = dict(avail0i=z, auto_target=True, max_coverage=C4_M)
    full_ms = best_ms(lambda: blocked.blocked_sweep_pass(
        p32, cnt, None, z, z, W, B, L, **kw), dev)[1]
    tail_ms = best_ms(lambda: blocked.blocked_sweep_pass(
        p32, cnt, None, z, z, W, B, L, grid_offset=tail, **kw), dev)[1]
    plain_ms = best_ms(lambda: blocked.blocked_sweep_pass_plain(
        p32, cnt, None, z, z, W, B, L, grid_offset=tail, **kw), dev, 1)[1]
    pos_full = nbw * B
    pos_tail = TAIL_BLOCKS * B
    full_bound, _ = sweep_bound(int(cnt.sum()), W, pos_full, L, 4 * cnt.numel())
    tail_bound, tail_by = sweep_bound(int(cnt[tail:].sum()), W, pos_tail, L,
                                      4 * cnt[tail:].numel())
    log(f"  kernel B full config-4 pass: {full_ms:.3f} ms for {pos_full} positions "
        f"x {W} windows ({1e6 * full_ms / pos_full:.1f} ns/position); bound "
        f"{full_bound:.4f} ms ({1e6 * full_bound / pos_full:.2f} ns/position, "
        f"{SWEEP_OPS} int32 ops per slot)  [{report}]")
    log(f"  tail slice ({pos_tail} positions x {W} windows): kernel {tail_ms:.3f} ms "
        f"({1e6 * tail_ms / pos_tail:.1f} ns/position), plain twin {plain_ms:.3f} ms "
        f"({1e6 * plain_ms / pos_tail:.1f} ns/position); bound {tail_bound:.4f} ms  "
        f"[{report}]")
    return {
        "name": "blocked_sweep", "route": "cuda",
        "source": "genome_downsampler_tpu_torch/ops/csrc/blocked_sweep.cu",
        "replaces": "genome_downsampler_tpu/ops/pallas_blocked.py:383",
        "max_abs_err": max(errs), "ms": tail_ms, "plain_ms": plain_ms,
        "bound_ms": tail_bound, "bound_by": tail_by, "library_ms": None,
        "timed_on": f"tail slice: {TAIL_BLOCKS} blocks x {W} windows, auto_target",
        "full_pass_ms": full_ms,
        "full_pass_ns_per_position": 1e6 * full_ms / pos_full,
        "full_pass_bound_ms": full_bound,
    }


def against_entries(key):
    """The C entries of the kernel ``key`` of ``AGAINST_KERNELS``."""
    return AGAINST_ENTRIES.get(key, (key,))


def against_entry(path):
    """The kernel, a key of ``AGAINST_KERNELS``, whose C entries the source
    at ``path`` defines (all of them)."""
    text = Path(path).read_text()
    found = [k for k in AGAINST_KERNELS
             if all(re.search(rf'extern\s+"C"\s+int\s+{e}\s*\(', text)
                    for e in against_entries(k))]
    if len(found) != 1:
        raise ValueError(f"{path} defines {found or 'none'} of {list(AGAINST_KERNELS)}")
    return found[0]


def start_against_builds(paths):
    """Start one ``nvcc -shared`` per other source and one ``nvcc -c`` of the
    port's source of each kernel they replace, all with ``-Xptxas -v``;
    returns ``{label: (entry, command, process)}``."""
    from genome_downsampler_tpu_torch.ops import build

    AGAINST_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    csrc = ROOT / "genome_downsampler_tpu_torch" / "ops" / "csrc"
    flags = [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(csrc)]
    entries = {path: against_entry(path) for path in paths}
    cmds = {}
    for entry in sorted(set(entries.values())):
        src = csrc / AGAINST_KERNELS[entry][0]
        cmds[f"port {src.name}"] = (entry, [*flags, "-c", "-o",
                                            str(AGAINST_DIR / f"port_{src.stem}.o"), str(src)])
    for i, path in enumerate(paths):
        cmds[path] = (entries[path],
                      [*flags, "-shared", "-o", str(AGAINST_DIR / f"lib{i}.so"), path])
    return {k: (e, c, subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True))
            for k, (e, c) in cmds.items()}


# one instantiation in ptxas -v's output: the kernel, its template arguments
# (slots per lane and the target or takes mode, or the ablation's mode; L
# for kernel C), spills and registers
PTXAS_ENTRY = re.compile(
    r"Compiling entry function '[^']*?(blocked_sweep_wide|blocked_sweep|dense_sweep|blocked_select"
    r"|sweep_variant|blocked_ablate|ssp)_kernel"
    r"(?:ILi(\d+)E(?:L[bi](\d)E)?)?[^']*'.*?(\d+) bytes spill stores, (\d+) bytes spill "
    r"loads.*?Used (\d+) registers", re.S)


def finish_against_builds(procs):
    """Wait for ``start_against_builds``; log each source's registers and
    spills per instantiation; returns ``{path: (entry, library)}``."""
    import ctypes

    from genome_downsampler_tpu_torch.ops import build

    libs = {}
    for label, (entry, cmd, proc) in procs.items():
        txt = proc.communicate()[0]
        if proc.returncode:
            raise build.KernelBuildError(f"{' '.join(cmd)}\n{txt}")
        log(f"  {label}: " + "; ".join(
            f"{k}<{','.join(x for x in (a, b) if x)}>: {r} registers, spill {st}/{ld} bytes"
            for k, a, b, st, ld, r in PTXAS_ENTRY.findall(txt)))
        if not label.startswith("port "):
            lib = ctypes.CDLL(str(cmd[cmd.index("-o") + 1]))
            for e in against_entries(entry):
                fn = getattr(lib, e)
                fn.restype = ctypes.c_int
                fn.argtypes = against_signature(label, e)
            libs[label] = (entry, lib)
    return libs


def in_turns(dev, lib, port, checks, timed, report):
    """``lib`` against the port's library: every run in ``checks`` bit-equal,
    then each of ``timed`` (``{cell: (run, positions)}`` or ``(run, count,
    reps, unit)``, ``run(library)`` launching the kernel once, uncounted)
    timed in turns: other, port, port, other, each the least of ``reps``
    launches (5; 1 is timed without a warm launch). Returns ``{"other cell":
    [ms, ms], "port cell": [ms, ms], ...}``."""
    from genome_downsampler_tpu_torch.scripts import best_ms

    for run in checks:
        max_abs_err(run(lib), run(port))
    log(f"  bit-equal to the port on {len(checks)} runs")
    times = {}
    for turn, (who, which) in enumerate((("other", lib), ("port", port), ("port", port),
                                         ("other", lib))):
        for cell, spec in timed.items():
            run, count, reps, unit = (*spec, 5, "position")[:4]
            ms = best_ms(lambda: run(which), dev, reps, warm=reps > 1)[1]
            times.setdefault(f"{who} {cell}", []).append(ms)
            log(f"  turn {turn} {who} {cell}: {ms:.4f} ms, "
                f"{1e6 * ms / count:.2f} ns/{unit}  [{report}]")
    return times


def turns_blocked_sweep(dev, c4):
    """Kernel B's cells: the config-4 full pass and tail slice (auto target),
    checked from zero and seeded carries."""
    import torch

    from genome_downsampler_tpu_torch.ops import build

    p32, cnt, W, B, L = c4["p32"], c4["counts"], c4["W"], c4["B"], c4["L"]
    nbw, _, cap = p32.shape
    tail = nbw - TAIL_BLOCKS
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(lib, off, carries):
        out = [torch.empty((W, (nbw - off) * B), dtype=torch.int32, device=dev)]
        out += [torch.empty((W, L), dtype=torch.int32, device=dev) for _ in range(3)]
        build.check("gd_blocked_sweep", lib.gd_blocked_sweep(
            cnt.data_ptr(), p32.data_ptr(), None, *(c.data_ptr() for c in carries),
            *(o.data_ptr() for o in out), nbw, W, cap, B, L, off, 1, C4_M, stream))
        return out

    g = torch.Generator().manual_seed(SEED)
    seeded = [torch.randint(0, 4, (W, L), generator=g, dtype=torch.int32).to(dev)
              for _ in range(3)]
    zero = [torch.zeros((W, L), dtype=torch.int32, device=dev)] * 3
    checks = [lambda lib, o=off, c=carries: run(lib, o, c)
              for off in (0, tail) for carries in (zero, seeded)]
    timed = {"full": (lambda lib: run(lib, 0, zero), nbw * B),
             "tail": (lambda lib: run(lib, tail, zero), TAIL_BLOCKS * B)}
    return checks, timed


def turns_dense_sweep(dev, c4):
    """Kernel A's cells: config-1 (S=1) in counts and takes mode, the edge
    (S=1, n=262,144) and S=32 rows of DENSE_ROWS positions at config-4's
    depth (300x); config-1 takes and the S=32 rows also from seeded
    carries."""
    import torch

    from genome_downsampler_tpu_torch.ops import build
    from genome_downsampler_tpu_torch.solvers.device_sweep import _dense_inputs

    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(lib, rows, target, carries, takes=False):
        S, n, L = rows.shape
        res = torch.empty((S, n, L) if takes else (S, n), dtype=torch.int32, device=dev)
        fin = [torch.empty((S, L), dtype=torch.int32, device=dev) for _ in range(2)]
        build.check("gd_dense_sweep", lib.gd_dense_sweep(
            rows.data_ptr(), target.data_ptr(), *(c.data_ptr() for c in carries),
            None if takes else res.data_ptr(), res.data_ptr() if takes else None,
            *(f.data_ptr() for f in fin), S, n, L, int(takes), stream))
        return [res, *fin]

    cells = {}
    for name, (pairs, n, m) in (("config-1", C1), ("edge", EDGE)):
        target, rows = _dense_inputs(uniform_batch(pairs, n), n, m, 256, dev)
        cells[name] = (rows, target)
    # S rows cut from one genome of S * DENSE_ROWS positions at 300x
    S = WINDOWS
    n = S * DENSE_ROWS
    pairs = 300 * n // (2 * READ_LEN)
    target, rows = _dense_inputs(uniform_batch(pairs, n), n, C4_M, 256, dev)
    cells[f"S={S}"] = (rows.view(S, DENSE_ROWS, 256), target.view(S, DENSE_ROWS))

    g = torch.Generator().manual_seed(SEED)
    zero = {k: [torch.zeros((k, 256), dtype=torch.int32, device=dev)] * 2 for k in (1, S)}
    seeded = {k: [torch.randint(0, 4, (k, 256), generator=g, dtype=torch.int32).to(dev)
                  for _ in range(2)] for k in (1, S)}
    timed = {
        name: (lambda lib, r=rows, t=target: run(lib, r, t, zero[r.shape[0]]), rows.shape[1])
        for name, (rows, target) in cells.items()
    }
    r1, t1 = cells["config-1"]
    timed["config-1 takes"] = (lambda lib: run(lib, r1, t1, zero[1], True), C1[1])
    rs, ts = cells[f"S={S}"]
    checks = [run_ for run_, _ in timed.values()] + [
        lambda lib: run(lib, r1, t1, seeded[1], True),
        lambda lib: run(lib, rs, ts, seeded[S]),
    ]
    return checks, timed


def turns_blocked_select(dev, c4):
    """Kernel C's cell: the config-4 full pass, on the windowed sweep's
    selection."""
    import torch

    from genome_downsampler_tpu_torch.ops import blocked, build

    p32, cnt, W, B, L = c4["p32"], c4["counts"], c4["W"], c4["B"], c4["L"]
    nbw, _, cap = p32.shape
    sel, _ = blocked.blocked_windowed_sweep(p32, cnt, None, W, B, L, auto_target=True,
                                            max_coverage=C4_M)
    xwin = c4["xwin"]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(lib):
        out = torch.empty((nbw, W, cap), dtype=torch.int8, device=dev)
        build.check("gd_blocked_select", lib.gd_blocked_select(
            p32.data_ptr(), cnt.data_ptr(), sel.data_ptr(), xwin.data_ptr(),
            out.data_ptr(), nbw, W, cap, B, L, stream))
        return [out]

    return [run], {"config-4": (run, nbw * B)}


def turns_ssp(dev, c4):
    """The SSP kernel's cells: the 3,000-base cut, config-1 and the QMCP
    edge, flows and (supply, status, phases, rounds) bit-equal on each; the
    edge timed once a turn (the one-CTA kernel takes about a minute there),
    config-1 the least of 3. An other source whose entry takes the one-CTA
    kernel's 16 arguments is called with that kernel's workspace."""
    import torch

    from genome_downsampler_tpu_torch.ops import build, ssp
    from genome_downsampler_tpu_torch.scripts.ssp_round_split import (
        ONE_CTA_SIGNATURE,
        one_cta_launch,
    )
    from genome_downsampler_tpu_torch.testing.ssp_cases import quality_cost, ssp_network

    def run(lib, arrays, cap):
        one_cta = len(lib.gd_ssp_solve.argtypes) == len(ONE_CTA_SIGNATURE)
        out = one_cta_launch(lib, arrays, cap) if one_cta else ssp.launch(lib, *arrays, cap)
        return [out[0], torch.tensor(out[1:])]

    checks, timed = [], {}
    for name, (pairs, n, m), reps in (("3,000-base cut", SSP_CUT, 5), ("config-1", C1, 3),
                                      ("QMCP edge", QMCP_EDGE, 1)):
        b = uniform_batch(pairs, n)
        arrays, supply = ssp_network(b.start, b.end, quality_cost(b.quality), n, m)
        arrays = [a.to(dev) for a in arrays]
        rounds = ssp.launch(build.load_kernels(), *arrays, supply + 16)[4]
        go = lambda lib, a=arrays, cap=supply + 16: run(lib, a, cap)  # noqa: E731
        checks.append(go)
        timed[name] = (go, rounds, reps, "round")
    return checks, timed


def turns_blocked_sweep_wide(dev, c4):
    """The wide path's cells: phase 3b's passes at L=1,024 and 4,096 and its
    deep stack, one full pass of each read set of phase 3c on its solve's
    codes (midnight-30kb: W=8, B=256, L=1,280; long-5mb: W=64, B=128,
    L=3,072; artic-deep-30kb: W=8, B=256, L=256) and the config-4 full pass
    (L=256), auto targets from zero carries; phase 3b's and artic-deep-30kb
    also checked from seeded carries at grid offset 1. An other source whose
    entry takes the earlier extra ``wide_tile`` gets 1 only where more
    than 65,535 reads of a group start at one position: the int32 tile the
    first wide source needs there (the later ones ignore it)."""
    import torch

    from genome_downsampler_tpu_torch.ops import blocked, build
    from genome_downsampler_tpu_torch.solvers.blocked_sweep import BlockedWindowedMcpSolver

    cells = {k: v[:7] for k, v in wide_cases(dev).items()}
    for label in WIDE_READ_SETS:
        batch, m = wide_read_batch(label)
        with selection_calls() as calls:
            BlockedWindowedMcpSolver("cuda").solve(m, batch)
        del batch
        p32, cnt, _, _, W, B, L = calls[-1][0]
        cells[label] = (p32, cnt, W, B, L, p32.shape[0] * B, m)
    cells["config-4 L=256"] = (c4["p32"], c4["counts"], c4["W"], c4["B"], c4["L"],
                               c4["win"], C4_M)
    deep = {cell: int(v[0].shape[2] > blocked._CUDA_MAX_STARTS and blocked._max_starts(
        v[0], v[3], v[4]) > blocked._CUDA_MAX_STARTS) for cell, v in cells.items()}
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator().manual_seed(SEED)
    # the carries, on the card before any timing: (cell, seeded) -> 3 rings
    carry = {(cell, seeded): [
        (torch.randint(0, 4, v[2:5:2], generator=g, dtype=torch.int32) if seeded
         else torch.zeros(v[2:5:2], dtype=torch.int32)).to(dev) for _ in range(3)]
        for cell, v in cells.items() for seeded in (False, True)}

    def run(lib, cell, off, seeded):
        p, c, W, B, L, _, m = cells[cell]
        nbw, _, cap = p.shape
        carries = carry[cell, seeded]
        out = [torch.empty((W, (nbw - off) * B), dtype=torch.int32, device=dev)]
        out += [torch.empty((W, L), dtype=torch.int32, device=dev) for _ in range(3)]
        fn = lib.gd_blocked_sweep_wide
        tile = [deep[cell]] if len(fn.argtypes) == len(WIDE_TILE_SIGNATURE) else []
        build.check("gd_blocked_sweep_wide", fn(
            c.data_ptr(), p.data_ptr(), None, *(x.data_ptr() for x in carries),
            *(o.data_ptr() for o in out), nbw, W, cap, B, L, off, 1, m, *tile, stream))
        return out

    checks = [lambda lib, k=cell: run(lib, k, 0, False) for cell in cells]
    checks += [lambda lib, k=cell: run(lib, k, 1, True)
               for cell in ("L=1024", "L=4096", "deep stack", "artic-deep-30kb")]
    timed = {cell: (lambda lib, k=cell: run(lib, k, 0, False), v[5])
             for cell, v in cells.items()}
    return checks, timed


def turns_sweep_variants(dev, c4):
    """The variants' cells, C and B each: the kernel_variants default row
    (n=30,208, L=256, M=1000), its first DEEP_CHECK positions and an L=64
    row (64 bp reads, otherwise the default); on each the port's C and B
    are first held to kernel A."""
    import torch

    from genome_downsampler_tpu_torch.ops import build, sweep, variants
    from genome_downsampler_tpu_torch.scripts import kernel_variants

    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(lib, entry, x, t):
        n, L = x.shape
        out = torch.empty(n, dtype=torch.int32, device=dev)
        build.check(entry, getattr(lib, entry)(x.data_ptr(), t.data_ptr(), out.data_ptr(),
                                               n, L, stream))
        return [out]

    rows, target = kernel_variants.problem(dev)
    cells = {"row": (rows, target),
             "head": (rows[:DEEP_CHECK].contiguous(), target[:DEEP_CHECK].contiguous()),
             "L=64": kernel_variants.problem(dev, read_len=64, max_span=64)}
    port = build.load_kernels()
    checks, timed = [], {}
    for cell, (x, t) in cells.items():
        n, L = x.shape
        z = torch.zeros((1, L), dtype=torch.int32, device=dev)
        ref = sweep.dense_sweep_counts(x[None], t[None], z, z, L)[0][0]
        for key, entry, xin in (("C", "gd_sweep_variant_c", x),
                                ("B", "gd_sweep_variant_b", variants.rotate_rows(x))):
            max_abs_err(run(port, entry, xin, t), [ref])
            go = lambda lib, e=entry, a=xin, b=t: run(lib, e, a, b)  # noqa: E731
            checks.append(go)
            timed[f"{key} {cell}"] = (go, n)
    log(f"  the port's variants == kernel A on {len(cells)} cells")
    return checks, timed


def ablate_small_case(dev):
    """Phase 12's small ablation case (the CPU tests' geometry, W=4, B=128,
    L=64, about 3 reads starting per position): ``(packed, target)``."""
    import numpy as np

    from genome_downsampler_tpu_torch.scripts import bench_kernel_ablate as bka

    rng = np.random.default_rng(SEED)
    start = np.sort(rng.integers(0, 1000 - 64, 3000))
    end = start + rng.integers(0, 63, 3000)
    return bka.pack(start, end, 1000, 4, 128, 64, 5, dev)[::2]


def turns_blocked_ablate(dev, c4):
    """The ablation's cells: every mode on the bench_kernel_ablate default
    (6M reads, W=64, B=128, L=256), checked there on its first TAIL_BLOCKS
    blocks and on phase 12's small case (W=4, B=128, L=64)."""
    import torch

    from genome_downsampler_tpu_torch.ops import ablate, build
    from genome_downsampler_tpu_torch.scripts import bench_kernel_ablate as bka

    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(lib, p, t, W, B, L, mode):
        out = torch.zeros((W, t.shape[1]), dtype=torch.int32, device=dev)
        carries = [torch.empty((W, L), dtype=torch.int32, device=dev) for _ in range(2)]
        build.check("gd_blocked_ablate", lib.gd_blocked_ablate(
            p.data_ptr(), t.data_ptr(), out.data_ptr(), *(c.data_ptr() for c in carries),
            p.shape[0], W, p.shape[2], B, L, ablate.MODES.index(mode), stream))
        return [out, *carries]

    W, B, L = 64, 128, bka.MAX_SPAN
    start, end, n = bka.problem(6.0)
    p, _, t, win = bka.pack(start, end, n, W, B, L, bka.MAX_COVERAGE, dev)
    head = (p[:TAIL_BLOCKS].contiguous(), t[:, :TAIL_BLOCKS * B].contiguous())
    small = ablate_small_case(dev)
    checks = [lambda lib, m=mode, c=case, w=w, ell=ell: run(lib, *c, w, B, ell, m)
              for mode in ablate.MODES
              for case, w, ell in ((small, 4, 64), (head, W, L))]
    timed = {mode: (lambda lib, m=mode: run(lib, p, t, W, B, L, m), win)
             for mode in ablate.MODES}
    return checks, timed


# the kernels --against takes, by the C entry the other source defines: the
# port's source of the kernel and the function that makes its cells
AGAINST_KERNELS = {"gd_blocked_ablate": ("blocked_ablate.cu", turns_blocked_ablate),
                   "gd_dense_sweep": ("dense_sweep.cu", turns_dense_sweep),
                   "gd_blocked_sweep": ("blocked_sweep.cu", turns_blocked_sweep),
                   "gd_blocked_sweep_wide": ("blocked_sweep_wide.cu",
                                             turns_blocked_sweep_wide),
                   "gd_blocked_select": ("blocked_select.cu", turns_blocked_select),
                   "gd_sweep_variant": ("sweep_variants.cu", turns_sweep_variants),
                   "gd_ssp_solve": ("ssp.cu", turns_ssp)}
# a kernel whose source defines more than one C entry: all of them
AGAINST_ENTRIES = {"gd_sweep_variant": ("gd_sweep_variant_c", "gd_sweep_variant_b")}


def against_signature(path, entry):
    """The ctypes argument types of ``entry`` as the source at ``path``
    declares it: the port's, or an earlier version's of the same count
    (the one-CTA SSP kernel's; the wide path's with ``wide_tile``)."""
    from genome_downsampler_tpu_torch.ops import build
    from genome_downsampler_tpu_torch.scripts.ssp_round_split import ONE_CTA_SIGNATURE

    earlier = {"gd_ssp_solve": [ONE_CTA_SIGNATURE],
               "gd_blocked_sweep_wide": [WIDE_TILE_SIGNATURE]}

    decl = re.search(rf'extern\s+"C"\s+int\s+{entry}\s*\(([^)]*)\)', Path(path).read_text())
    nargs = decl.group(1).count(",") + 1
    for sig in (build._SIGNATURES[entry], *earlier.get(entry, ())):
        if len(sig) == nargs:
            return sig
    raise ValueError(f"{path}: {entry} takes {nargs} arguments, no known version does")


def phase_turns(dev, c4, libs, report):
    """Each other source against the port's version of its kernel, bit-equal
    and in turns, at that kernel's cells. Returns ``{path: {"entry": ...,
    "times": {"other cell": [ms, ms], "port cell": [ms, ms], ...}}}``."""
    from genome_downsampler_tpu_torch.ops import build

    port = build.load_kernels()
    res = {}
    for path, (entry, lib) in libs.items():
        source, cells = AGAINST_KERNELS[entry]
        log(f"  {path} ({entry}) against the port's {source}")
        checks, timed = cells(dev, c4)
        res[path] = {"entry": entry,
                     "times": in_turns(dev, lib, port, checks, timed, report)}
    return res


def phase_select(dev, c4, report):
    """Kernel C against its twin and the argsort engine at config-4."""
    import torch

    from genome_downsampler_tpu_torch.ops import blocked
    from genome_downsampler_tpu_torch.scripts import best_ms
    from genome_downsampler_tpu_torch.solvers.blocked_sweep import (
        _selection_mask,
        pack_bits,
    )

    p32, cnt, W, B, L = c4["p32"], c4["counts"], c4["W"], c4["B"], c4["L"]
    sel, rounds = blocked.blocked_windowed_sweep(
        p32, cnt, None, W, B, L, auto_target=True, max_coverage=C4_M
    )
    xwin = c4["xwin"]
    got = blocked.blocked_selection_pass(p32, cnt, sel, xwin, W, B, L)
    torch.cuda.synchronize()
    ref = blocked.blocked_selection_pass_plain(p32, cnt, sel, xwin, W, B, L)
    err = max_abs_err([got], [ref])
    bits, n_sel = _selection_mask(p32, sel, W, B, L, c4["win"])
    if not torch.equal(pack_bits(got), bits) or int(got.sum()) != n_sel:
        raise AssertionError("kernel C disagrees with the argsort engine")
    log(f"  kernel C == plain == argsort engine at config-4 "
        f"({int(got.sum())} selected slots, {rounds} sweep rounds)")
    ms = best_ms(lambda: blocked.blocked_selection_pass(p32, cnt, sel, xwin, W, B, L),
                 dev)[1]
    plain_ms = best_ms(
        lambda: blocked.blocked_selection_pass_plain(p32, cnt, sel, xwin, W, B, L), dev, 1
    )[1]
    codes = int(cnt.sum())
    bound_ms, bound_by = bound(
        SELECT_OPS * codes,
        4 * (codes + cnt.numel() + sel.numel() + xwin.numel()) + got.numel())
    log(f"  kernel C full config-4 pass: {ms:.3f} ms, plain twin {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})  [{report}]")
    return {
        "name": "blocked_select", "route": "cuda",
        "source": "genome_downsampler_tpu_torch/ops/csrc/blocked_select.cu",
        "replaces": "genome_downsampler_tpu/ops/pallas_blocked.py:704",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "timed_on": f"full config-4 pass: {p32.shape[0]} blocks x {W} windows",
    }


def phase_main_path(dev, batch, report):
    """mcp-cuda through the registry at config-4, against mcp-cpu."""
    import numpy as np
    import torch

    from genome_downsampler_tpu_torch.solvers.native_greedy import NativeGreedyMcpSolver
    from genome_downsampler_tpu_torch.solvers.registry import default_registry

    reg = default_registry()
    solver = reg.get("mcp-cuda")
    solver.solve(C4_M, batch)  # warm-up: library load, allocator, clocks
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sel = solver.solve(C4_M, batch)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = read_launches()
    stats = solver.inner.last_stats
    if stats["engine"] != "blocked":
        raise AssertionError(f"mcp-cuda ran the {stats['engine']} engine at config-4")

    t0 = time.perf_counter()
    host = reg.get("mcp-cpu").solve(C4_M, batch)
    host_s = time.perf_counter() - t0
    assert isinstance(reg.get("mcp-cpu").inner, NativeGreedyMcpSolver)
    if not np.array_equal(sel, host):
        raise AssertionError(
            f"mcp-cuda read set differs from mcp-cpu ({len(sel)} vs {len(host)})"
        )
    check_valid(dev, batch, sel, C4_M)
    expect_launches(launches, "blocked_sweep", "blocked_select")
    log(f"  mcp-cuda == mcp-cpu: {len(sel)} of {batch.n_reads} reads selected; "
        f"coverage valid at all {batch.ref_genome_length} bases")
    log(f"  launches in the timed solve: {launches}")
    log(f"  last_stats: {json.dumps(stats)}")
    log(f"  warm end-to-end mcp-cuda solve {e2e:.4f} s vs host C++ greedy "
        f"(mcp-cpu) {host_s:.4f} s  [{report}]")
    return launches, host


def check_valid(dev, batch, sel, m):
    """``min(cov_in, M) <= cov_out`` at every base, on the card."""
    import torch

    from genome_downsampler_tpu_torch.ops.coverage import (
        coverage_from_intervals,
        coverage_is_valid,
    )

    s = torch.tensor(batch.start, device=dev)
    e = torch.tensor(batch.end, device=dev)
    idx = torch.tensor(sel, device=dev)
    n = batch.ref_genome_length
    cov_in = coverage_from_intervals(s, e, n)
    cov_out = coverage_from_intervals(s[idx], e[idx], n)
    if not coverage_is_valid(cov_in, cov_out, m):
        raise AssertionError("min(cov_in, M) <= cov_out fails somewhere")


def phase_cli(report):
    """BAM -> BAM through the port's CLI with mcp-cuda (the dense engine at
    30 kb), mcp-cuda --windows 4 and mcp-cpu."""
    import numpy as np

    from genome_downsampler_tpu_torch.config import BamApiConfig
    from genome_downsampler_tpu_torch.io.bam import read_bam
    from genome_downsampler_tpu_torch.testing.bam_writer import write_test_bam_fast
    from genome_downsampler_tpu_torch.testing.reads_gen import rand_reads_uniform

    rng = np.random.default_rng(SEED)
    batch = rand_reads_uniform(rng, 100_000, 30_000, 150)
    runs = {"mcp-cuda": ["-a", "mcp-cuda"],
            "mcp-cuda --windows 4": ["-a", "mcp-cuda", "--windows", "4"],
            "mcp-cpu": ["-a", "mcp-cpu"]}
    with tempfile.TemporaryDirectory() as d:
        src = Path(d) / "in.bam"
        write_test_bam_fast(src, batch)
        outs = {}
        for i, (name, flags) in enumerate(runs.items()):
            out = Path(d) / f"out{i}.bam"
            t0 = time.perf_counter()
            subprocess.run(
                [sys.executable, "-m", "genome_downsampler_tpu_torch", str(src),
                 "100", "-o", str(out), *flags, "-l", "0", "-q", "0"],
                cwd=ROOT, check=True, timeout=600,
            )
            log(f"  CLI {' '.join(flags)}: {time.perf_counter() - t0:.3f} s "
                "(process, incl. start-up)")
            outs[name] = out
        cfg = BamApiConfig(min_seq_length=0, min_mapq=0)
        ref, _, _ = read_bam(outs["mcp-cpu"], cfg)
        for name in ("mcp-cuda", "mcp-cuda --windows 4"):
            a, _, _ = read_bam(outs[name], cfg)
            same = a.n_reads == ref.n_reads and all(
                np.array_equal(getattr(a, f), getattr(ref, f))
                for f in ("start", "end", "quality", "bam_id")
            )
            if not same:
                raise AssertionError(f"CLI outputs of {name} and mcp-cpu differ")
            identical = outs[name].read_bytes() == outs["mcp-cpu"].read_bytes()
            log(f"  CLI {name} == mcp-cpu: the same {a.n_reads} records of "
                f"{batch.n_reads} (byte-identical files: {identical})  [{report}]")


def uniform_batch(pairs, genome, seed=SEED):
    import numpy as np

    from genome_downsampler_tpu_torch.testing.reads_gen import rand_reads_uniform

    return rand_reads_uniform(np.random.default_rng(seed), pairs, genome, READ_LEN)


def kernel_a_vs_plain(what, rows, target, a0, s0, takes=False):
    """Kernel A against its twin on the same inputs; returns (max |err|,
    the twin's ms)."""
    import torch

    from genome_downsampler_tpu_torch.ops import sweep
    from genome_downsampler_tpu_torch.scripts import best_ms

    L = rows.shape[2]
    got = sweep.dense_sweep_counts(rows, target, a0, s0, L, takes=takes)
    torch.cuda.synchronize()
    ref, plain_ms = best_ms(lambda: sweep.dense_sweep_counts_plain(
        rows, target, a0, s0, L, takes=takes), rows.device, 1, warm=False)
    err = max_abs_err(got, ref)
    seeded = bool(a0.any() or s0.any())
    log(f"  kernel A == plain: {what} S={rows.shape[0]} n={rows.shape[1]} "
        f"L={L} takes={takes} seeded={seeded}")
    return err, plain_ms


def row_head(x, n):
    """The first ``n`` positions of every row, contiguous."""
    return x[:, :n].contiguous()


@contextlib.contextmanager
def recorded_calls(module, name, fn):
    """Record the arguments of every call a path makes through
    ``module.<name>`` (which is ``fn``): the shapes and carries it gives the
    kernel. The launches run, and count, as they would without it."""
    calls = []

    def recorded(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)

    setattr(module, name, recorded)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def kernel_a_calls(module):
    """``recorded_calls`` of kernel A's wrapper as ``module`` calls it."""
    from genome_downsampler_tpu_torch.ops import sweep

    return recorded_calls(module, "dense_sweep_counts", sweep.dense_sweep_counts)


def dense_bound(S, n, L):
    """Kernel A's (or a variant's) bound on S rows of n positions: the rows
    and targets read once, the counts written once, SWEEP_OPS per slot."""
    return bound(SWEEP_OPS * S * n * L, 4 * (S * n * L + 2 * S * n))


def phase_dense_kernel(dev, report):
    """Kernel A against its twin; returns the kernel's JSON entry."""
    import torch

    from genome_downsampler_tpu_torch.ops import sweep
    from genome_downsampler_tpu_torch.scripts import best_ms
    from genome_downsampler_tpu_torch.solvers.device_sweep import _dense_inputs

    errs = []

    def check(what, rows, target, a0, s0, takes):
        err, plain_ms = kernel_a_vs_plain(what, rows, target, a0, s0, takes)
        errs.append(err)
        return plain_ms

    # the CPU tests' shapes: L=64, n=4096
    for S in (1, 4):
        rows, targets = [], []
        for i in range(S):
            b = uniform_batch(2000, 4096, SEED + i)
            t, r = _dense_inputs(b, 4096, 3 + i, 64, dev)
            rows.append(r)
            targets.append(t)
        rows, target = torch.cat(rows), torch.cat(targets)
        g = torch.Generator().manual_seed(SEED)
        for seeded in (False, True):
            carries = [
                (torch.randint(0, 4, (S, 64), generator=g, dtype=torch.int32)
                 if seeded else torch.zeros((S, 64), dtype=torch.int32)).to(dev)
                for _ in range(2)
            ]
            for takes in (False, True):
                check("small", rows, target, *carries, takes)

    # config-1, the whole genome
    pairs, n, m = C1
    target, rows = _dense_inputs(uniform_batch(pairs, n), n, m, 256, dev)
    z = torch.zeros((1, 256), dtype=torch.int32, device=dev)
    plain_ms = check("config-1", rows, target, z, z, False)
    check("config-1", rows, target, z, z, True)
    ms = best_ms(lambda: sweep.dense_sweep_counts(rows, target, z, z, 256), dev)[1]
    takes_ms = best_ms(
        lambda: sweep.dense_sweep_counts(rows, target, z, z, 256, takes=True), dev)[1]

    # deep 30 kb: the twin checks the first positions, the kernel runs all
    pairs, n, m = DEEP
    target, rows = _dense_inputs(uniform_batch(pairs, n), n, m, 256, dev)
    head_r, head_t = row_head(rows, DEEP_CHECK), row_head(target, DEEP_CHECK)
    deep_plain_ms = check("deep 30 kb head", head_r, head_t, z, z, False)
    full = sweep.dense_sweep_counts(rows, target, z, z, 256)[0]
    head = sweep.dense_sweep_counts(head_r, head_t, z, z, 256)[0]
    errs.append(max_abs_err([full[:, :DEEP_CHECK]], [head]))
    deep_ms = best_ms(lambda: sweep.dense_sweep_counts(rows, target, z, z, 256), dev)[1]
    deep_head_ms = best_ms(lambda: sweep.dense_sweep_counts(head_r, head_t, z, z, 256),
                           dev)[1]
    log(f"  config-1 ({C1[1]} positions): kernel {ms:.3f} ms "
        f"({1e6 * ms / C1[1]:.1f} ns/position), takes mode {takes_ms:.3f} ms, "
        f"plain twin {plain_ms:.3f} ms  [{report}]")
    log(f"  deep 30 kb ({DEEP[1]} positions): kernel {deep_ms:.3f} ms "
        f"({1e6 * deep_ms / DEEP[1]:.1f} ns/position); first {DEEP_CHECK} positions: "
        f"kernel {deep_head_ms:.3f} ms, plain twin {deep_plain_ms:.3f} ms  [{report}]")
    bound_ms, bound_by = dense_bound(1, C1[1], 256)
    log(f"  config-1 bound {bound_ms:.4f} ms ({bound_by})  [{report}]")
    return {
        "name": "dense_sweep", "route": "cuda",
        "source": "genome_downsampler_tpu_torch/ops/csrc/dense_sweep.cu",
        "replaces": "genome_downsampler_tpu/ops/pallas_sweep.py:55",
        "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "timed_on": f"config-1: S=1, n={C1[1]}, L=256",
        "takes_ms": takes_ms, "deep_30kb_ms": deep_ms,
        "deep_head_ms": deep_head_ms, "deep_head_plain_ms": deep_plain_ms,
    }


def solve_pair(dev, reg, name, batch, m, report, label):
    """Warm solve of ``name`` with the counts reset just before and read
    just after, against mcp-cpu; returns (selection, mcp-cpu's selection,
    launches, {"solve_s", "host_s", "stats"})."""
    import numpy as np
    import torch

    solver = reg.get(name)
    solver.solve(m, batch)  # warm-up
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sel = solver.solve(m, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    t0 = time.perf_counter()
    host = reg.get("mcp-cpu").solve(m, batch)
    host_s = time.perf_counter() - t0
    if name.startswith("mcp") and not np.array_equal(sel, host):
        raise AssertionError(f"{name} read set differs from mcp-cpu at {label} "
                             f"({len(sel)} vs {len(host)})")
    check_valid(dev, batch, sel, m)
    stats = getattr(solver.inner, "last_stats", None)
    log(f"  {label}: {name} {len(sel)} of {batch.n_reads} reads, coverage valid "
        f"at all {batch.ref_genome_length} bases; launches {launches}; warm solve "
        f"{dt:.4f} s vs mcp-cpu {host_s:.4f} s  [{report}]")
    if stats:
        log(f"    last_stats: {json.dumps(stats)}")
    return sel, host, launches, {"solve_s": dt, "host_s": host_s, "stats": stats}


def phase_dense_path(dev, report):
    """mcp-cuda at config-1, the deep 30 kb and the edge: the dense
    engine. Kernel A against its twin on the head of each path's own
    launch, and timed on the whole of it. Returns ({cell: kernel A's
    launches in the cell's run}, max |err|, {cell: kernel ms})."""
    from genome_downsampler_tpu_torch.ops import sweep
    from genome_downsampler_tpu_torch.scripts import best_ms
    from genome_downsampler_tpu_torch.solvers import device_sweep
    from genome_downsampler_tpu_torch.solvers.registry import default_registry

    reg = default_registry()
    launches, errs, kernel_ms = {}, [], {}
    for label, (pairs, n, m) in (("config-1", C1), ("deep 30 kb", DEEP),
                                 ("edge", EDGE)):
        batch = uniform_batch(pairs, n)
        if reg.get("mcp-cuda").inner._pick_engine(n) != "dense":
            raise AssertionError(f"{label}: {n} bases do not pick the dense engine")
        with kernel_a_calls(device_sweep) as calls:
            _, _, launches[label], _ = solve_pair(dev, reg, "mcp-cuda", batch, m,
                                                  report, label)
        expect_launches(launches[label], "dense_sweep")
        args, kw = calls[-1]
        rows, target, a0, s0, L = args
        errs.append(kernel_a_vs_plain(
            f"{label} path's launch, head", row_head(rows, DEEP_CHECK),
            row_head(target, DEEP_CHECK), a0, s0, **kw)[0])
        kernel_ms[label] = best_ms(lambda: sweep.dense_sweep_counts(*args, **kw),
                                   rows.device, 3)[1]
        bound_ms, bound_by = dense_bound(*rows.shape)
        log(f"  {label}: kernel A alone on the path's launch (S={rows.shape[0]}, "
            f"n={rows.shape[1]}): {kernel_ms[label]:.3f} ms "
            f"({1e6 * kernel_ms[label] / rows.shape[1]:.1f} ns/position); bound "
            f"{bound_ms:.4f} ms ({bound_by})  [{report}]")
        del calls, args, rows, target
    return {k: v["dense_sweep"] for k, v in launches.items()}, max(errs), kernel_ms


def phase_windowed(batch, host, report):
    """The windowed solver at config-4, warm; kernel A against its twin on
    the last round's launch (S=W rows, seeded carries). Returns (max |err|,
    kernel ms of that launch, its bound ms, kernel A's launches)."""
    import numpy as np
    import torch

    from genome_downsampler_tpu_torch.ops import sweep
    from genome_downsampler_tpu_torch.parallel import windows
    from genome_downsampler_tpu_torch.scripts import best_ms

    solver = windows.WindowedMcpSolver("cuda", n_windows=WINDOWS)
    solver.solve(C4_M, batch)  # warm-up
    with kernel_a_calls(windows) as calls:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sel = solver.solve(C4_M, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_launches()
    expect_launches(launches, "dense_sweep")
    if not np.array_equal(sel, host):
        raise AssertionError(f"windowed read set differs from mcp-cpu "
                             f"({len(sel)} vs {len(host)})")
    rounds = solver.last_stats["rounds"]
    if launches["dense_sweep"] != rounds:
        raise AssertionError(f"{rounds} rounds but {launches} launches")
    log(f"  windowed W={WINDOWS} == mcp-cpu at config-4: {len(sel)} reads; "
        f"{rounds} rounds; launches {launches}; warm solve {dt:.4f} s  [{report}]")

    # the last round: the head of every window from its seeded carries, and
    # the tail of every window (the highest addresses of the rows) from the
    # carries the kernel leaves after the rest, against the whole launch
    rows, target, a0, s0, L = calls[-1][0]
    n, T = rows.shape[1], WIN_CHECK
    errs = [kernel_a_vs_plain("windowed last round, head", row_head(rows, T),
                              row_head(target, T), a0, s0)[0]]
    full = sweep.dense_sweep_counts(rows, target, a0, s0, L)
    _, a_mid, s_mid = sweep.dense_sweep_counts(
        row_head(rows, n - T), row_head(target, n - T), a0, s0, L)
    ref = sweep.dense_sweep_counts_plain(
        rows[:, n - T:].contiguous(), target[:, n - T:].contiguous(), a_mid, s_mid, L)
    errs.append(max_abs_err([full[0][:, n - T:], full[1], full[2]], ref))
    log(f"  kernel A whole launch == kernel on the first {n - T} positions, then "
        f"plain on the last {T}: S={rows.shape[0]} n={n} L={L}")
    ms = best_ms(lambda: sweep.dense_sweep_counts(rows, target, a0, s0, L),
                 rows.device, 3)[1]
    bound_ms, bound_by = dense_bound(*rows.shape)
    log(f"  kernel A alone on one round (S={rows.shape[0]}, n={n}): {ms:.3f} ms "
        f"({1e6 * ms / n:.1f} ns/position); bound {bound_ms:.4f} ms ({bound_by})  "
        f"[{report}]")
    return max(errs), ms, bound_ms, launches["dense_sweep"]


def phase_batched(report):
    """solve_batch over 8 samples, warm; kernel A against its twin on the
    head of the launch's 8 rows. Returns max |err|."""
    import numpy as np
    import torch

    from genome_downsampler_tpu_torch.solvers import batched
    from genome_downsampler_tpu_torch.solvers.registry import default_registry

    pairs, n, m = C1
    batches = [uniform_batch(pairs, n, SEED + i) for i in range(8)]
    batched.solve_batch(batches, m, "cuda")  # warm-up
    with kernel_a_calls(batched) as calls:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sels = batched.solve_batch(batches, m, "cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_launches()
    expect_launches(launches, "dense_sweep")
    if launches["dense_sweep"] != 1:
        raise AssertionError(f"solve_batch took {launches} launches, not one")
    host = default_registry().get("mcp-cpu")
    t0 = time.perf_counter()
    for i, (b, sel) in enumerate(zip(batches, sels)):
        if not np.array_equal(sel, host.solve(m, b)):
            raise AssertionError(f"batched sample {i} differs from mcp-cpu")
    host_s = time.perf_counter() - t0
    log(f"  solve_batch over 8 config-1 samples == mcp-cpu on each "
        f"({[len(x) for x in sels]} reads); launches {launches}; warm "
        f"{dt:.4f} s vs mcp-cpu on the 8 in turn {host_s:.4f} s  [{report}]")
    rows, target, a0, s0, _ = calls[-1][0]
    return kernel_a_vs_plain("batched launch, head", row_head(rows, DEEP_CHECK),
                             row_head(target, DEEP_CHECK), a0, s0)[0]


def phase_qmcp(dev, report):
    import numpy as np

    from genome_downsampler_tpu_torch.solvers.device_sweep import QmcpDeviceSweepSolver
    from genome_downsampler_tpu_torch.solvers.registry import default_registry

    pairs, n, m = C1
    batch = uniform_batch(pairs, n)
    reg = default_registry()
    sel, host, launches, _ = solve_pair(dev, reg, "qmcp-sweep-cuda", batch, m, report,
                                     "config-1")
    expect_launches(launches, "dense_sweep")
    cpu = QmcpDeviceSweepSolver("cpu").solve(m, batch)
    if not np.array_equal(sel, cpu):
        raise AssertionError("qmcp-sweep-cuda differs from its CPU twin solver")
    if len(sel) != len(host):
        raise AssertionError(f"qmcp-sweep-cuda count {len(sel)} != mcp-cpu {len(host)}")
    q = np.asarray(batch.quality, np.int64)
    mcp = reg.get("mcp-cuda").solve(m, batch)
    if q[sel].sum() < q[mcp].sum():
        raise AssertionError("qmcp-sweep-cuda lost total MAPQ against mcp-cuda")
    log(f"  qmcp-sweep-cuda == CPU twin solver; count {len(sel)} == mcp-cpu; "
        f"total MAPQ {int(q[sel].sum())} >= mcp-cuda's {int(q[mcp].sum())}")


def phase_variants(dev, report):
    """Kernel A's variants through the kernel_variants entry point at its
    default size, against kernel A and sweep_counts over the whole row; each
    against its twin on the first DEEP_CHECK positions. Returns their JSON
    entries."""
    import torch

    from genome_downsampler_tpu_torch.ops import sweep, variants
    from genome_downsampler_tpu_torch.scripts import best_ms, kernel_variants

    reset_launches()
    torch.cuda.synchronize()
    res, rows, target = kernel_variants.run(
        dev, log=lambda *a: log("  " + " ".join(map(str, a))))
    launches = read_launches()
    expect_launches(launches, "dense_sweep", "variant_c", "variant_b")
    if not all(r["match"] for r in res.values()):
        raise AssertionError("a kernel differs from sweep_counts at the "
                             "kernel_variants default")
    a = res["A"]["out"]
    n, L = rows.shape
    # each instantiation's resources, as the built kernels report them
    info = {key: {f: {ell: variants.kernel_info(ell, key == "B")[f]
                      for ell in variants._CUDA_SPANS}
                  for f in ("registers", "local_bytes", "chunk_positions")}
            for key in "CB"}
    head_r, head_t = rows[:DEEP_CHECK].contiguous(), target[:DEEP_CHECK].contiguous()
    z = torch.zeros((1, L), dtype=torch.int32, device=dev)
    a_head_ms = best_ms(lambda: sweep.dense_sweep_counts(head_r[None], head_t[None],
                                                         z, z, L), dev)[1]
    split = kernel_variants.ns_split(res, n)
    entries = []
    for key, name, fn, plain, x in (
        ("C", "variant_c", variants.sweep_variant_c, variants.sweep_variant_c_plain,
         head_r),
        ("B", "variant_b", variants.sweep_variant_b, variants.sweep_variant_b_plain,
         variants.rotate_rows(head_r)),
    ):
        got = fn(x, head_t, L)
        torch.cuda.synchronize()
        ref, plain_ms = best_ms(lambda: plain(x, head_t, L), dev, 1, warm=False)
        err = max(max_abs_err([got], [ref]),
                  max_abs_err([res[key]["out"]], [a]),
                  max_abs_err([res[key]["out"][:DEEP_CHECK]], [got]))
        ms = best_ms(lambda: fn(x, head_t, L), dev)[1]
        log(f"  variant {key} == kernel A == sweep_counts over n={n}; == plain twin "
            f"on the first {DEEP_CHECK} positions")
        entries.append({
            "name": name, "route": "cuda",
            "source": "genome_downsampler_tpu_torch/ops/csrc/sweep_variants.cu",
            "replaces": "scripts/kernel_variants.py:"
                        + ("31" if key == "C" else "68"),
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            **dict(zip(("bound_ms", "bound_by"), dense_bound(1, DEEP_CHECK, L))),
            "timed_on": f"first {DEEP_CHECK} positions of the kernel_variants "
                        f"default (L={L})",
            "row_ms": res[key]["ms"], "kernel_a_row_ms": res["A"]["ms"],
            "ns_per_position": split[key], "kernel_a_ns_per_position": split["A"],
            "a_minus_c_ns_per_position": split["A-C"],
            "c_minus_b_ns_per_position": split["C-B"],
            **info[key],
        })
    log(f"  whole row, n={n} (least of 5): kernel A {res['A']['ms']:.3f} ms "
        f"({split['A']:.2f} ns/position), variant C {res['C']['ms']:.3f} ms "
        f"({split['C']:.2f}), variant B {res['B']['ms']:.3f} ms ({split['B']:.2f}); "
        f"A - C {split['A-C']:.2f} ns/position, C - B {split['C-B']:.2f}  [{report}]")
    for key, ent in zip("CB", entries):
        log(f"  variant {key} per L: registers {ent['registers']}, local (spill) bytes "
            f"{ent['local_bytes']}, positions a chunk {ent['chunk_positions']}")
    log(f"  first {DEEP_CHECK} positions: kernel A {a_head_ms:.3f} ms, variant C "
        f"{entries[0]['ms']:.3f} ms (twin {entries[0]['plain_ms']:.3f} ms), "
        f"variant B {entries[1]['ms']:.3f} ms (twin {entries[1]['plain_ms']:.3f} ms)"
        f"  [{report}]")
    return entries


def ablate_vs_plain(packed, target, W, B, L):
    """Every mode of the ablation kernel against its twin on the same
    inputs (``out``, ``availf`` and ``selendf``); returns (max |err|, the
    twin's ms per mode)."""
    import torch

    from genome_downsampler_tpu_torch.ops import ablate
    from genome_downsampler_tpu_torch.scripts import best_ms

    errs, plain_ms = [], {}
    for mode in ablate.MODES:
        got = ablate.blocked_ablate(packed, target, W, B, L, mode)
        torch.cuda.synchronize()
        ref, plain_ms[mode] = best_ms(
            lambda: ablate.blocked_ablate_plain(packed, target, W, B, L, mode),
            packed.device, 1, warm=False)
        errs.append(max_abs_err(got, ref))
    log(f"  ablation == plain twin in all {len(ablate.MODES)} modes: W={W} B={B} "
        f"L={L}, {packed.shape[0]} blocks")
    return max(errs), plain_ms


def phase_ablate(dev, report, b_ns):
    """The ablation: every mode against its twin at W=4, B=128, L=64;
    ``full`` against kernel A over whole window rows at 1M reads; the seven
    modes timed through the bench_kernel_ablate entry point at its default,
    ``full`` there equal to kernel B on the same codes and timed beside it,
    the step's pieces; each mode against its twin on the first TAIL_BLOCKS
    blocks of it; each instantiation's registers and spills. Returns the
    kernel's JSON entry."""
    import torch

    from genome_downsampler_tpu_torch.ops import ablate, sweep
    from genome_downsampler_tpu_torch.scripts import best_ms
    from genome_downsampler_tpu_torch.scripts import bench_kernel_ablate as bka

    W, B, L = 64, 128, bka.MAX_SPAN
    p, t = ablate_small_case(dev)
    errs = [ablate_vs_plain(p, t, 4, B, 64)[0]]

    # full over whole windows at 1M reads against kernel A over their rows
    start, end, n = bka.problem(1.0)
    p, _, t, win = bka.pack(start, end, n, W, B, L, bka.MAX_COVERAGE, dev)
    out = ablate.blocked_ablate(p, t, W, B, L, "full")[0]
    rows = bka.window_rows(start, end, win, W, win, L, dev)
    z = torch.zeros((W, L), dtype=torch.int32, device=dev)
    errs.append(max_abs_err([out], [sweep.dense_sweep_counts(rows, t, z, z, L)[0]]))
    log(f"  full == kernel A over the {W} whole window rows at 1M reads (S={W}, "
        f"n={win}, {rows.numel() * 4 / 1e9:.2f} GB of rows)")
    del p, t, out, rows
    torch.cuda.empty_cache()

    reset_launches()
    torch.cuda.synchronize()
    res = bka.run(dev, log=lambda *a: log("  " + " ".join(map(str, a))))
    launches = read_launches()
    expect_launches(launches, "ablate", "dense_sweep", "blocked_sweep")
    r = res[(W, B)]
    errs.append(max_abs_err([r["full"]["out"][:, :r["kernel_a"].shape[1]]],
                            [r["kernel_a"]]))
    if not r["match_b"]:
        raise AssertionError("full differs from kernel B on the default's codes")
    pieces = r["pieces_ns"]
    kb_ns = r["kernel_b"]["ns_per_step"]
    log(f"  modes at 6M reads, W={W} B={B} (ns per step, one position of {W} "
        f"windows): " + ", ".join(f"{m} {r[m]['ns_per_step']:.1f}" for m in ablate.MODES)
        + f"; kernel B on the same codes {kb_ns:.1f} (turns full "
        f"{r['turns']['full']}, B {r['turns']['kernel_b']} ms); kernel B full config-4 "
        f"pass {b_ns:.1f} ns/position (W=32)  [{report}]")
    log("  pieces (ns per step): " + ", ".join(f"{k} {v:.1f}" for k, v in pieces.items())
        + f"  [{report}]")
    # each instantiation's resources, as the built kernels report them
    built = {(m, ell): ablate.kernel_info(B, ell, m)
             for m in ablate.MODES for ell in ablate._CUDA_SPANS}
    info = {f: {m: {ell: built[m, ell][f] for ell in ablate._CUDA_SPANS}
                for m in ablate.MODES}
            for f in ("registers", "local_bytes")}
    log(f"  registers per mode and L: {info['registers']}; local (spill) bytes "
        f"{info['local_bytes']}")

    # every mode, kernel and twin, on the first TAIL_BLOCKS blocks of it
    p = r["packed"][:TAIL_BLOCKS].contiguous()
    t = r["target"][:, :TAIL_BLOCKS * B].contiguous()
    modes_ms = {m: r[m]["ms"] for m in ablate.MODES}
    modes_ns = {m: r[m]["ns_per_step"] for m in ablate.MODES}
    turns = r["turns"]
    del res, r
    err, plain_ms = ablate_vs_plain(p, t, W, B, L)
    errs.append(err)
    ms = best_ms(lambda: ablate.blocked_ablate(p, t, W, B, L, "full"), dev)[1]
    log(f"  full on the first {TAIL_BLOCKS} blocks (W={W}): kernel {ms:.3f} ms, "
        f"plain twin {plain_ms['full']:.3f} ms  [{report}]")
    return {
        "name": "ablate", "route": "cuda",
        "source": "genome_downsampler_tpu_torch/ops/csrc/blocked_ablate.cu",
        "replaces": "scripts/bench_kernel_ablate.py:32",
        "launches": launches["ablate"], "max_abs_err": max(errs), "ms": ms,
        "plain_ms": plain_ms["full"], "library_ms": None,
        **dict(zip(("bound_ms", "bound_by"), sweep_bound(
            int((p >= 0).sum()), W, TAIL_BLOCKS * B, L, 4 * t.numel()))),
        "timed_on": f"mode full, first {TAIL_BLOCKS} blocks of the default "
                    f"(6M reads, W={W}, B={B}, L={L})",
        "modes_ms": modes_ms, "modes_ns_per_step": modes_ns, "pieces_ns": pieces,
        "kernel_b_ns_per_step": kb_ns, "turns_ms": turns, **info,
    }


def ssp_bound(n, B, rounds):
    """The SSP kernel's bound on this run: per fixpoint round the node and
    bucket arrays moved once and SSP_OPS operations a node and bucket side."""
    return bound(rounds * SSP_OPS * (n + 1 + 2 * B),
                 rounds * 4 * (SSP_NODE_ARRAYS * (n + 1) + SSP_BUCKET_ARRAYS * B))


def phase_ssp_kernel(dev, report):
    """The SSP kernel against its twin on the JAX suite's six random LP
    inputs, the card tests' four CTA-boundary cases, the 3,000-base cut and
    config-1 (n + 1 = 29,904 nodes over 117 CTAs of 256, so the carries
    between CTAs are held to the twin); timed on config-1, the shape the
    main path gives it, on the cut, and on the QMCP edge (no twin there:
    phase 14 holds the solve to qmcp-cpu, ``--against`` the kernel to an
    earlier source). Returns its entry."""
    import numpy as np
    import torch

    from genome_downsampler_tpu_torch.ops import ssp
    from genome_downsampler_tpu_torch.scripts import best_ms
    from genome_downsampler_tpu_torch.testing.ssp_cases import (
        BOUNDARY_CASES,
        boundary_case,
        quality_cost,
        ssp_network,
    )

    def lp_case(seed):  # tests/test_device_mcmf.py::test_device_ssp_matches_lp_random
        rng = np.random.default_rng(seed)
        r = int(rng.integers(8, 300))
        start = rng.integers(0, 600, r)
        end = np.minimum(start + rng.integers(1, 150, r), 599)
        return start, end, rng.integers(1, 60, r), 600, int(rng.integers(1, 9))

    def reads_case(pairs, n, m):
        b = uniform_batch(pairs, n)
        return (np.asarray(b.start, np.int64), np.asarray(b.end, np.int64),
                quality_cost(b.quality), n, m)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [(f"LP seed {i}", lp_case(i)) for i in range(6)]
    cases += [(name, boundary_case(name)) for name in BOUNDARY_CASES]
    cases.append(("3,000-base cut", reads_case(*SSP_CUT)))
    cases.append(("config-1", reads_case(*C1)))
    cases.append(("QMCP edge", reads_case(*QMCP_EDGE)))
    errs, timed = [], {}
    for what, case in cases:
        arrays, supply = ssp_network(*case)
        cap = supply + 16
        on_dev = [a.to(dev) for a in arrays]
        got = ssp.ssp_solve(*on_dev, cap)
        B, n = arrays[0].shape[0], arrays[-1].shape[0] - 1
        G, C = ssp.grid_shape(n, sms)
        if got[2] != ssp.OK:
            raise AssertionError(f"SSP kernel status {got[2]} on {what}")
        plain_ms = None
        if what != "QMCP edge":
            ref, plain_ms = best_ms(lambda: ssp.ssp_solve_plain(*on_dev, cap), dev, 1,
                                    warm=False)
            errs.append(max_abs_err([got[0]], [ref[0]]))
            if got[1:] != ref[1:]:
                raise AssertionError(f"SSP kernel (supply, status, phases, rounds) "
                                     f"{got[1:]} != twin {ref[1:]} on {what}")
            log(f"  SSP kernel == plain on {what}: B={B}, n={n}, {G} CTAs of {C} nodes, "
                f"{got[3]} phases, {got[4]} rounds, status OK")
        if what in ("3,000-base cut", "config-1", "QMCP edge"):
            reps = 3 if what == "QMCP edge" else 5
            ms = best_ms(lambda: ssp.ssp_solve(*on_dev, cap), dev, reps)[1]
            rounds = got[4]
            bound_ms, bound_by = ssp_bound(n, B, rounds)
            timed[what] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "n": n, "B": B, "ctas": G,
                           "phases": got[3], "rounds": rounds,
                           "us_per_round": 1e3 * ms / rounds}
            log(f"  SSP kernel on {what}: {ms:.3f} ms ({1e3 * ms / rounds:.2f} us a "
                f"fixpoint round, {rounds} rounds, {G} CTAs), plain twin "
                + (f"{plain_ms:.1f} ms" if plain_ms is not None else "not run")
                + f"; bound {bound_ms:.4f} ms ({bound_by})  [{report}]")
        del on_dev
    c1 = timed["config-1"]
    keys = ("ms", "plain_ms", "bound_ms", "n", "B", "ctas", "phases", "rounds", "us_per_round")
    return {
        "name": "ssp", "route": "cuda",
        "source": "genome_downsampler_tpu_torch/ops/csrc/ssp.cu",
        "replaces": "genome_downsampler_tpu/solvers/device_mcmf.py:198",
        "max_abs_err": max(errs), "ms": c1["ms"], "plain_ms": c1["plain_ms"],
        "bound_ms": c1["bound_ms"], "bound_by": c1["bound_by"], "library_ms": None,
        "timed_on": f"config-1: n={c1['n']}, B={c1['B']}, {c1['ctas']} CTAs, "
                    f"{c1['phases']} phases, {c1['rounds']} rounds",
        "us_per_round": c1["us_per_round"], "ctas": c1["ctas"],
        "cut": {k: timed["3,000-base cut"][k] for k in keys},
        "edge": {k: timed["QMCP edge"][k] for k in keys},
    }


def qmcp_pair(dev, reg, batch, m, label, report):
    """Warm qmcp-cuda (warmed on other data) against qmcp-cpu on one batch,
    launches counted; returns (launches, stats, cuda s, cpu s)."""
    import numpy as np
    import torch

    from genome_downsampler_tpu_torch.testing.ssp_cases import quality_cost

    solver = reg.get("qmcp-cuda")
    pairs = batch.n_reads // 2
    solver.solve(m, uniform_batch(pairs, batch.ref_genome_length, SEED + 1))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sel = solver.solve(m, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    t0 = time.perf_counter()
    host = reg.get("qmcp-cpu").solve(m, batch)
    host_s = time.perf_counter() - t0
    cost = quality_cost(batch.quality)
    if int(cost[sel].sum()) != int(cost[host].sum()):
        raise AssertionError(f"qmcp-cuda cost {cost[sel].sum()} != qmcp-cpu "
                             f"{cost[host].sum()} at {label}")
    check_valid(dev, batch, np.asarray(sel), m)
    stats = solver.inner.last_stats
    log(f"  {label}: qmcp-cuda == qmcp-cpu in cost ({int(cost[sel].sum())}), "
        f"{len(sel)} and {len(host)} of {batch.n_reads} reads, coverage valid; "
        f"warm qmcp-cuda {dt:.4f} s vs qmcp-cpu {host_s:.4f} s; launches {launches}  "
        f"[{report}]")
    log(f"    last_stats: {json.dumps(stats)}")
    return launches, stats, dt, host_s


def phase_qmcp_exact(dev, report):
    """qmcp-cuda against qmcp-cpu at config-1, 32,768 and 65,536 bases and
    the edge; a genome above the limit goes to the host engine. Returns
    each solve's SSP launches, times, phases and rounds."""
    from genome_downsampler_tpu_torch.solvers.device_mcmf import DEVICE_GENOME_LIMIT
    from genome_downsampler_tpu_torch.solvers.registry import default_registry

    reg = default_registry()
    out = {}
    for label, (pairs, n, m) in (("config-1", C1), ("32,768 bases", QMCP_32K),
                                 ("65,536 bases", QMCP_64K), ("edge", QMCP_EDGE),
                                 ("above the limit", QMCP_HOST)):
        launches, stats, dt, host_s = qmcp_pair(dev, reg, uniform_batch(pairs, n), m,
                                                label, report)
        engine = "host" if n > DEVICE_GENOME_LIMIT else "device"
        if stats["engine"] != engine:
            raise AssertionError(f"{label}: engine {stats['engine']}, not {engine}")
        expect_launches(launches, *(["ssp"] if engine == "device" else []))
        if engine == "device" and launches["ssp"] != 1:
            raise AssertionError(f"{label}: {launches['ssp']} SSP launches, not 1")
        out[label] = {"launches": launches["ssp"], "qmcp_cuda_s": dt,
                      "qmcp_cpu_s": host_s, "phases": stats["phases"],
                      "rounds": stats["rounds"], "buckets": stats["buckets"]}
    return out


def busy_share(prof, window_s):
    """(device busy share of the window, {kernel: device ms}) from a
    torch.profiler run: the union of the device intervals over the host's
    window, and the device time summed by name."""
    from torch.autograd import DeviceType

    spans, per = [], {}
    for e in prof.events():
        # kernels and copies; not the solvers' named regions mirrored there
        if e.device_type == DeviceType.CUDA and not (
                getattr(e, "is_user_annotation", False)
                or e.name.startswith(("blocked.", "dense.", "qmcp.", "flow."))):
            spans.append((e.time_range.start, e.time_range.end))
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return (busy / 1e6 / window_s if spans else None), per


def phase_profile(dev, report):
    """torch.profiler around one warm config-4 mcp-cuda solve and one warm
    config-1 qmcp-cuda solve. Returns {solve: busy share}."""
    import torch

    from genome_downsampler_tpu_torch.solvers.registry import default_registry
    from genome_downsampler_tpu_torch.utils.profiling import TRACE_FILE, trace

    reg = default_registry()
    c1 = uniform_batch(*C1[:2])
    runs = {"config-4 mcp-cuda": ("mcp-cuda", config4_batch(), C4_M),
            "config-1 qmcp-cuda": ("qmcp-cuda", c1, C1[2])}
    shares = {}
    for i, (label, (name, batch, m)) in enumerate(runs.items()):
        solver = reg.get(name)
        solver.solve(m, batch)  # warm
        out = PROFILE_DIR / ("config4" if i == 0 else "qmcp")
        torch.cuda.synchronize()
        with trace(out) as prof:
            t0 = time.perf_counter()
            solver.solve(m, batch)
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        if not (out / TRACE_FILE).exists():
            raise AssertionError(f"no trace written under {out}")
        share, per = busy_share(prof, window)
        shares[label] = share
        top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
        log(f"  {label}: traced window {window:.4f} s, device busy "
            + (f"{100 * share:.2f}% (idle {100 * (1 - share):.2f}%)" if share is not None
               else "not measured (the profiler saw no device activity)")
            + f"; trace {out / TRACE_FILE}  [{report}]")
        for k, v in top:
            log(f"    device {v:.3f} ms  {k[:90]}")
        del batch
    return shares


def phase_push_relabel(dev, report):
    """quasi-mcp-flow-cuda through the registry, warm, beside mcp-cpu: at
    the 3,000-base cut and config-1 the read set and the supersteps equal
    the same solver's on the CPU; coverage valid at all three cells, the
    selection smaller than the reads; no hand kernel launched (the solver
    is torch ops on the card); the card's busy share of one traced cut
    solve. Returns {cell: counts, times, bound}."""
    import numpy as np
    import torch

    from genome_downsampler_tpu_torch.solvers.push_relabel import QuasiMcpPushRelabelSolver
    from genome_downsampler_tpu_torch.solvers.registry import default_registry
    from genome_downsampler_tpu_torch.utils.profiling import trace

    reg = default_registry()
    solver = reg.get("quasi-mcp-flow-cuda")
    cut = uniform_batch(*SSP_CUT[:2])
    solver.solve(SSP_CUT[2], cut)  # warm (torch ops: nothing compiles per size)
    out = {}
    for label, (pairs, n, m), hold in (("3,000-base cut", SSP_CUT, True),
                                       ("config-1", C1, True),
                                       ("1M pairs over 30 kb", FLOW_LARGEST, False)):
        batch = uniform_batch(pairs, n)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sel = solver.solve(m, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        expect_launches(read_launches())
        stats = solver.inner.last_stats
        t0 = time.perf_counter()
        host = reg.get("mcp-cpu").solve(m, batch)
        host_s = time.perf_counter() - t0
        check_valid(dev, batch, sel, m)
        if not len(sel) < batch.n_reads:
            raise AssertionError(f"{label}: no downsampling ({len(sel)} of {batch.n_reads})")
        cell = {"reads": batch.n_reads, "n": n, "M": m, "selected": len(sel),
                "mcp_cpu_selected": len(host), "solve_s": dt, "mcp_cpu_s": host_s}
        if hold:
            cpu = QuasiMcpPushRelabelSolver("cpu")
            t0 = time.perf_counter()
            cpu_sel = cpu.solve(m, batch)
            cell["cpu_solve_s"] = time.perf_counter() - t0
            if not np.array_equal(sel, cpu_sel):
                raise AssertionError(f"{label}: read set differs from the CPU run "
                                     f"({len(sel)} vs {len(cpu_sel)})")
            if cpu.last_stats["supersteps"] != stats["supersteps"]:
                raise AssertionError(f"{label}: {stats['supersteps']} supersteps, "
                                     f"{cpu.last_stats['supersteps']} on the CPU")
        pad = solver.inner.pad_multiple
        r_pad = -(-batch.n_reads // pad) * pad
        arcs = 2 * r_pad + 2 * n + 3 * (n + 1)
        b_ms, b_by = bound(0, FLOW_BYTES_PER_ARC * arcs)
        round_ms = bound(0, FLOW_ROUND_BYTES_PER_NODE * (n + 1)
                         + FLOW_ROUND_BYTES_PER_READ * r_pad)[0]
        table_ms = bound(0, FLOW_TABLE_BYTES_PER_READ * r_pad + FLOW_TABLE_BYTES_PER_ARC * arcs)[0]
        laps = stats["laps_s"]
        cell.update({k: stats[k] for k in ("supersteps", "bodies", "global_relabels",
                                           "closure_rounds", "host_syncs")})
        cell.update(arcs=arcs, laps_s=laps,
                    ms_per_superstep=1e3 * laps["supersteps"] / stats["bodies"],
                    ms_per_closure_round=1e3 * laps["relabel"] / stats["closure_rounds"],
                    bound_ms_per_superstep=b_ms, bound_by=b_by,
                    bound_ms_per_closure_round=round_ms, arcs_lap_ms=1e3 * laps["arcs"],
                    bound_ms_arc_table=table_ms)
        out[label] = cell
        log(f"  {label}: quasi-mcp-flow-cuda {len(sel)} of {batch.n_reads} reads "
            f"(mcp-cpu {len(host)}), coverage valid"
            + (", read set and supersteps equal to the CPU run "
               f"({cell['cpu_solve_s']:.2f} s)" if hold else "")
            + f"; {stats['supersteps']} supersteps ({stats['bodies']} run), "
            f"{stats['global_relabels']} global relabels, {stats['closure_rounds']} "
            f"closure rounds, {stats['host_syncs']} host syncs; warm solve {dt:.4f} s vs "
            f"mcp-cpu {host_s:.4f} s; {cell['ms_per_superstep']:.4f} ms a superstep "
            f"(bound {b_ms:.5f} ms, {b_by}, A={arcs}), "
            f"{cell['ms_per_closure_round']:.4f} ms a closure round (bound {round_ms:.6f}); "
            f"arcs lap {cell['arcs_lap_ms']:.3f} ms (the table's bound {table_ms:.5f})  "
            f"[{report}]")
        log(f"    laps: {json.dumps(laps)}")
    # where a solve's wall time goes: the card's busy share of one cut solve
    # (a config-1 trace would hold about a million events)
    torch.cuda.synchronize()
    with trace(PROFILE_DIR / "flow") as prof:
        t0 = time.perf_counter()
        solver.solve(SSP_CUT[2], cut)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    share, per = busy_share(prof, window)
    out["3,000-base cut"]["busy_share"] = share
    log(f"  3,000-base cut traced: window {window:.4f} s, device busy "
        + (f"{100 * share:.2f}%" if share is not None else "not measured")
        + f"; the busiest device ops: "
        + ", ".join(f"{k[:40]} {v:.2f} ms" for k, v in
                    sorted(per.items(), key=lambda kv: -kv[1])[:4]) + f"  [{report}]")
    log(json.dumps({"push_relabel": out}))
    return out


def wide_cases(dev):
    """Phase 3b's inputs of kernel B's wide path, ``{cell: (packed, counts,
    W, B, L, positions a window, M, start, end)}``: long reads at L=1,024
    and 4,096 (W=4, B=128, about 2 reads starting a position, spans
    1..L-1) and the deep stack (W=2, B=64, L=64: 70,000 reads of one window
    starting at one position, more than uint16 counts)."""
    import numpy as np
    import torch

    from genome_downsampler_tpu_torch import _native

    rng = np.random.default_rng(SEED)
    cases = {}
    W, B = 4, 128
    for L in (1024, 4096):
        n = W * max(4 * B, L)
        start = rng.integers(0, n - L, 2 * n)
        end = start + rng.integers(0, L - 1, 2 * n)
        packed, counts, win, _, _ = _native.pack_blocked(start, end, n, W, B, L,
                                                         cap_multiple=64)
        cases[f"L={L}"] = (torch.tensor(packed, device=dev), torch.tensor(counts, device=dev),
                           W, B, L, win, 9, start, end)
    W, L, n, hot = 2, 64, 256, 70_000
    start = rng.integers(0, n - L, 2 * n)
    end = np.concatenate([start + rng.integers(0, L - 1, 2 * n), np.full(hot, 64 + 35)])
    start = np.concatenate([start, np.full(hot, 64 + 5)])
    packed, counts, win, _, _ = _native.pack_blocked(start, end, n, W, 64, L, cap_multiple=64)
    cases["deep stack"] = (torch.tensor(packed, device=dev), torch.tensor(counts, device=dev),
                           W, 64, L, win, 80_000, start, end)
    return cases


def wide_bound(codes, W, positions, L, extra_bytes):
    """The wide path's bound: the bytes of ``sweep_bound`` and the per-end
    step's operations (WIDE_POSITION_OPS a position and window, WIDE_READ_OPS
    a read); returns ``(bound_ms, bound_by, bytes-only ms)``."""
    nbytes = 4 * (codes + W * positions + 6 * W * L) + extra_bytes
    ms, by = bound(WIDE_POSITION_OPS * W * positions + WIDE_READ_OPS * codes, nbytes)
    return ms, by, 1e3 * nbytes / HBM_BYTES_PER_S


def phase_wide_sweep(dev, c4, report):
    """Kernel B's wide path against its twin: long reads at L=1,024 and
    4,096 from zero carries with auto targets and from seeded carries at
    grid offset 1 with given targets, the deep stack; kernel C's
    run-time-L instantiation at both L; the wide path called directly on
    the config-4 full pass (L=256), equal to the register path there and to
    the twin on its tail slice. Returns (the wide path's entry, kernel C's
    max |err|)."""
    import torch

    from genome_downsampler_tpu_torch import _native
    from genome_downsampler_tpu_torch.ops import blocked
    from genome_downsampler_tpu_torch.scripts import best_ms
    from genome_downsampler_tpu_torch.solvers.blocked_sweep import (
        _cross_window_offsets,
        _selection_mask,
        pack_bits,
    )

    errs, sel_errs, ent = [], [], {}
    for cell, (p, c, W, B, L, win, m, start, end) in wide_cases(dev).items():
        z = torch.zeros((W, L), dtype=torch.int32, device=dev)
        kw = dict(avail0i=z, auto_target=True, max_coverage=m)
        got = blocked.blocked_sweep_pass(p, c, None, z, z, W, B, L, **kw)
        torch.cuda.synchronize()
        ref, plain_ms = best_ms(lambda: blocked.blocked_sweep_pass_plain(
            p, c, None, z, z, W, B, L, **kw), dev, 1, warm=False)
        errs.append(max_abs_err(got, ref))
        g = torch.Generator().manual_seed(SEED)
        seeded = [torch.randint(0, 4, (W, L), generator=g, dtype=torch.int32).to(dev)
                  for _ in range(3)]
        n_pad = W * win
        tgt = torch.tensor(_native.capped_target(start, end, n_pad, m).reshape(W, win),
                           device=dev)
        kw1 = dict(grid_offset=1, avail0i=seeded[2])
        got = blocked.blocked_sweep_pass(p, c, tgt, *seeded[:2], W, B, L, **kw1)
        torch.cuda.synchronize()
        errs.append(max_abs_err(got, blocked.blocked_sweep_pass_plain(
            p, c, tgt, *seeded[:2], W, B, L, **kw1)))
        if cell == "deep stack":
            if int(ref[0].max()) <= 65535:
                raise AssertionError("the deep stack case does not exceed uint16")
            log(f"  kernel B wide path == plain: 70,000 reads starting at one position, "
                f"{int(ref[0].max())} selected ending at one position; seeded, grid "
                f"offset 1")
            continue
        ms = best_ms(lambda: blocked.blocked_sweep_pass(p, c, None, z, z, W, B, L, **kw),
                     dev)[1]
        codes, extra = int(c.sum()), 4 * c.numel()
        b_ms, b_by, bytes_ms = wide_bound(codes, W, win, L, extra)
        ent[cell] = {"ms": ms, "ns_per_position": 1e6 * ms / win, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "bytes_bound_ms": bytes_ms,
                     "slot_bound_ms": sweep_bound(codes, W, win, L, extra)[0]}
        sel, _ = blocked.blocked_windowed_sweep(p, c, None, W, B, L, auto_target=True,
                                                max_coverage=m)
        xwin = torch.tensor(_cross_window_offsets(start, end, win, W, B, L), device=dev)
        got = blocked.blocked_selection_pass(p, c, sel, xwin, W, B, L)
        torch.cuda.synchronize()
        sel_errs.append(max_abs_err([got], [blocked.blocked_selection_pass_plain(
            p, c, sel, xwin, W, B, L)]))
        bits, n_sel = _selection_mask(p, sel, W, B, L, win)
        if not torch.equal(pack_bits(got), bits) or int(got.sum()) != n_sel:
            raise AssertionError(f"kernel C disagrees with the argsort engine at {cell}")
        log(f"  kernel B wide path and kernel C == plain at {cell} (W={W}, B={B}, "
            f"{win} positions a window; zero and seeded carries): wide path {ms:.4f} ms, "
            f"{1e6 * ms / win:.1f} ns/position; plain twin {plain_ms:.1f} ms; bound "
            f"{b_ms:.5f} ms ({b_by}; bytes alone {bytes_ms:.5f} ms, the slot-wise step's "
            f"operations {ent[cell]['slot_bound_ms']:.4f} ms)  [{report}]")

    # the config-4 full pass through the wide path (L=256), against the
    # register path on the whole pass and the twin on the tail slice
    p32, cnt, W, B, L = c4["p32"], c4["counts"], c4["W"], c4["B"], c4["L"]
    nbw = p32.shape[0]
    z = torch.zeros((W, L), dtype=torch.int32, device=dev)
    kw = dict(avail0i=z, auto_target=True, max_coverage=C4_M)
    got = blocked.blocked_sweep_wide(p32, cnt, None, z, z, W, B, L, **kw)
    errs.append(max_abs_err(got, blocked.blocked_sweep_pass(p32, cnt, None, z, z, W, B, L,
                                                            **kw)))
    tail = nbw - TAIL_BLOCKS
    got = blocked.blocked_sweep_wide(p32, cnt, None, z, z, W, B, L, grid_offset=tail, **kw)
    torch.cuda.synchronize()
    errs.append(max_abs_err(got, blocked.blocked_sweep_pass_plain(
        p32, cnt, None, z, z, W, B, L, grid_offset=tail, **kw)))
    c4_ms = best_ms(lambda: blocked.blocked_sweep_wide(p32, cnt, None, z, z, W, B, L, **kw),
                    dev)[1]
    reg_ms = best_ms(lambda: blocked.blocked_sweep_pass(p32, cnt, None, z, z, W, B, L, **kw),
                     dev)[1]
    pos = nbw * B
    log(f"  config-4 full pass (W={W}, B={B}, L={L}, {pos} positions) through the wide "
        f"path == the register path, tail slice == plain: wide path {c4_ms:.3f} ms "
        f"({1e6 * c4_ms / pos:.1f} ns/position), register path {reg_ms:.3f} ms "
        f"({1e6 * reg_ms / pos:.1f} ns/position)  [{report}]")
    a, b4 = ent["L=1024"], ent["L=4096"]
    return {
        "name": "blocked_sweep_wide", "route": "cuda",
        "source": "genome_downsampler_tpu_torch/ops/csrc/blocked_sweep_wide.cu",
        "replaces": "genome_downsampler_tpu/ops/pallas_blocked.py:383",
        "max_abs_err": max(errs), "ms": a["ms"], "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"], "bound_by": a["bound_by"], "library_ms": None,
        "timed_on": "L=1,024: W=4, B=128, 1,024 positions a window, auto_target",
        "ns_per_position": a["ns_per_position"], "bytes_bound_ms": a["bytes_bound_ms"],
        "slot_bound_ms": a["slot_bound_ms"], "L4096": b4,
        "config4_L256_ms": c4_ms, "config4_L256_ns_per_position": 1e6 * c4_ms / pos,
        "config4_register_path_ms": reg_ms,
    }, max(sel_errs)


def wide_read_batch(label):
    """``(ReadBatch, M)`` of a read set of ``WIDE_READ_SETS``, from SEED."""
    import numpy as np

    from genome_downsampler_tpu_torch.testing import long_reads

    make, m = WIDE_READ_SETS[label]
    return getattr(long_reads, make)(np.random.default_rng(SEED)), m


def selection_calls():
    """``recorded_calls`` of kernel C's wrapper as the blocked solver calls
    it: the solve's packed codes, counts, selection and cross-window
    offsets, and its geometry."""
    from genome_downsampler_tpu_torch.ops import blocked
    from genome_downsampler_tpu_torch.solvers import blocked_sweep

    return recorded_calls(blocked_sweep, "blocked_selection_pass",
                          blocked.blocked_selection_pass)


def phase_long_reads(dev, report):
    """``mcp-cuda-blocked`` on the read sets of ``WIDE_READ_SETS`` against
    ``mcp-cpu``: read set equal, coverage valid, the wide path and kernel C
    launched and the register path not; the laps and rounds. On the solve's
    own last kernel C arguments (packed codes, counts, selection,
    cross-window offsets): one full pass of the wide path from zero
    carries and kernel C, each held to its twin and timed (ns per
    position). Returns ``{cell: {...}}``."""
    import torch

    from genome_downsampler_tpu_torch.ops import blocked
    from genome_downsampler_tpu_torch.scripts import best_ms
    from genome_downsampler_tpu_torch.solvers.registry import default_registry

    reg = default_registry()
    out = {}
    for label in WIDE_READ_SETS:
        batch, m = wide_read_batch(label)
        with selection_calls() as calls:
            _, _, launches, info = solve_pair(dev, reg, "mcp-cuda-blocked", batch, m,
                                              report, label)
        expect_launches(launches, "blocked_sweep_wide", "blocked_select")
        reads, genome = batch.n_reads, batch.ref_genome_length
        del batch
        p32, cnt, sel, xwin, W, B, L = calls[-1][0]
        stats = info["stats"]
        nbw = p32.shape[0]
        win = nbw * B
        z = torch.zeros((W, L), dtype=torch.int32, device=dev)
        kw = dict(avail0i=z, auto_target=True, max_coverage=m)
        got = blocked.blocked_sweep_wide(p32, cnt, None, z, z, W, B, L, **kw)
        torch.cuda.synchronize()
        ref, plain_ms = best_ms(lambda: blocked.blocked_sweep_pass_plain(
            p32, cnt, None, z, z, W, B, L, **kw), dev, 1, warm=False)
        err = max_abs_err(got, ref)
        del got, ref
        got = blocked.blocked_selection_pass(p32, cnt, sel, xwin, W, B, L)
        torch.cuda.synchronize()
        sel_ref, sel_plain_ms = best_ms(lambda: blocked.blocked_selection_pass_plain(
            p32, cnt, sel, xwin, W, B, L), dev, 1, warm=False)
        sel_err = max_abs_err([got], [sel_ref])
        del got, sel_ref
        pass_ms = best_ms(lambda: blocked.blocked_sweep_wide(p32, cnt, None, z, z, W, B, L,
                                                             **kw), dev, 3)[1]
        sel_ms = best_ms(lambda: blocked.blocked_selection_pass(p32, cnt, sel, xwin, W, B, L),
                         dev)[1]
        codes = int(cnt.sum())
        b_ms, b_by, bytes_ms = wide_bound(codes, W, win, L, 4 * cnt.numel())
        out[label] = {
            "reads": reads, "genome": genome, "M": m,
            "W": W, "B": B, "L": L, "positions_per_pass": win,
            "launches": launches, "rounds": stats["rounds"], "laps_s": stats["phases_s"],
            "solve_s": info["solve_s"], "mcp_cpu_s": info["host_s"],
            "pass_ms": pass_ms, "ns_per_position": 1e6 * pass_ms / win,
            "pass_bound_ms": b_ms, "pass_bound_by": b_by, "pass_bytes_bound_ms": bytes_ms,
            "pass_slot_bound_ms": sweep_bound(codes, W, win, L, 4 * cnt.numel())[0],
            "pass_plain_ms": plain_ms, "max_abs_err": err, "select_ms": sel_ms,
            "select_plain_ms": sel_plain_ms, "select_max_abs_err": sel_err,
        }
        log(f"  {label} (W={W}, B={B}, L={L}, {win} positions a window, {codes} codes): "
            f"{stats['rounds']} rounds; laps "
            + ", ".join(f"{k} {v:.4f}" for k, v in stats["phases_s"].items())
            + f" s; one full pass of the wide path == plain, {pass_ms:.3f} ms "
            f"({1e6 * pass_ms / win:.1f} ns/position; bound {b_ms:.4f} ms, {b_by}; plain "
            f"twin {plain_ms:.1f} ms); kernel C == plain, {sel_ms:.4f} ms (plain twin "
            f"{sel_plain_ms:.1f} ms)  [{report}]")
    return out


def bounded_pairs(pairs, genome, max_insert, seed=SEED):
    """150 bp pairs whose mates start at most ``max_insert - READ_LEN``
    apart (uniform first mates, the layout of a real library): a sharded
    run's halo can hold every pair. ``rand_reads_uniform`` places mates
    independently, farther apart than any halo, and the fast BAM writer
    writes no mate position, so the region read could not even report
    those drops."""
    import numpy as np

    from genome_downsampler_tpu_torch.core.readbatch import ReadBatch

    rng = np.random.default_rng(seed)
    first = rng.integers(0, genome - max_insert, pairs)
    second = first + rng.integers(0, max_insert - READ_LEN + 1, pairs)
    start = np.empty(2 * pairs, np.int64)
    start[0::2], start[1::2] = first, second
    return ReadBatch(
        bam_id=np.arange(2 * pairs, dtype=np.int64), start=start,
        end=start + READ_LEN - 1, quality=rng.integers(0, 61, 2 * pairs),
        seq_length=np.full(2 * pairs, READ_LEN, np.int64),
        is_first=np.tile([True, False], pairs), ref_genome_length=genome,
    )


def indexed_bam(path, batch):
    """Write ``batch`` with the fast writer and index it (``write_bai``
    over the records' voffsets, read back from the file)."""
    import numpy as np

    from genome_downsampler_tpu_torch.config import BamApiConfig
    from genome_downsampler_tpu_torch.io.bai import write_bai
    from genome_downsampler_tpu_torch.io.bam import read_bam_region
    from genome_downsampler_tpu_torch.testing.bam_writer import write_test_bam_fast

    write_test_bam_fast(path, batch)
    region = read_bam_region(path, BamApiConfig(min_mapq=0, min_seq_length=0), 0,
                             batch.ref_genome_length)
    got = region.batch
    if got.n_reads != batch.n_reads:
        raise AssertionError(f"{path.name}: read back {got.n_reads} of {batch.n_reads}")
    order = np.argsort(got.bam_id)
    write_bai(str(path) + ".bai", got.start[order], got.end[order], got.bam_id[order])


def cli_ranks(args, n_procs, timeout=900):
    """The port's CLI as ``n_procs`` ranks of one ``--sharded`` job (the
    GD_* environment, a free port), or one plain run; returns (wall s,
    {rank: the laps it logged})."""
    import os

    from genome_downsampler_tpu_torch.testing.mesh_worker import free_port

    env = dict(os.environ, GD_COORDINATOR=f"127.0.0.1:{free_port()}",
               GD_NUM_PROCESSES=str(n_procs))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        logs = [Path(d) / f"rank{r}.log" for r in range(n_procs)]
        procs = []
        try:
            for r in range(n_procs):
                with open(logs[r], "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "genome_downsampler_tpu_torch", *args],
                        cwd=ROOT, env=dict(env, GD_PROCESS_ID=str(r)), stdout=f,
                        stderr=subprocess.STDOUT))
            for p in procs:
                p.wait(timeout=timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        texts = [f.read_text() for f in logs]
    failed = [f"rank {r} of {n_procs} (rc {p.returncode}):\n{text[-3000:]}"
              for r, (p, text) in enumerate(zip(procs, texts)) if p.returncode != 0]
    if failed:
        raise AssertionError(f"CLI {' '.join(args)} failed:\n" + "\n".join(failed))
    laps = {}
    for text in texts:
        for line in text.splitlines():
            m = re.search(r"sharded laps \(rank (\d+)\): (.*)$", line)
            if m:
                laps[int(m.group(1))] = json.loads(m.group(2))
    return wall, laps


def same_records(a, b) -> str:
    """"file" if the two BAMs are byte-equal, "records" if their
    decompressed streams are; raises otherwise."""
    import gzip

    if a.read_bytes() == b.read_bytes():
        return "file"
    if gzip.decompress(a.read_bytes()) == gzip.decompress(b.read_bytes()):
        return "records"
    raise AssertionError(f"{a.name} and {b.name} hold different records")


def phase_sharded(dev, report):
    """[17] the mesh engines and ``--sharded`` on the card. (a) world size 1
    over NCCL, in-process: the blocked mesh at config-4 (read set equal to
    mcp-cpu, coverage valid, one kernel B pass a round, timed beside
    mcp-cuda's blocked engine) and the dense mesh at config-1 and the edge
    (sel equal to kernel A on the whole genome, one launch); (b) two ranks
    on the one card over gloo: the dry run at L=32 and the config-4 blocked
    mesh split 2 x 16 windows, sel equal to (a); (c) the CLI BAM -> BAM,
    ``-a mcp-cuda --sharded`` at 1 and 2 processes byte-equal to ``-a
    mcp-cuda`` and ``-a mcp-cpu``, and ``-a qmcp-cuda --sharded`` at 2
    processes equal to 1. Returns the ``{"sharded": ...}`` object and
    kernels A's and B's launches in (a)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from genome_downsampler_tpu_torch.ops import sweep
    from genome_downsampler_tpu_torch.parallel.launch import (
        global_window_mesh,
        initialize_distributed,
    )
    from genome_downsampler_tpu_torch.parallel.mesh import solve_on_mesh
    from genome_downsampler_tpu_torch.parallel.sharded_io import solve_blocked_on_mesh
    from genome_downsampler_tpu_torch.solvers.device_sweep import (
        _dense_inputs,
        reconstruct_selection,
    )
    from genome_downsampler_tpu_torch.solvers.registry import default_registry
    from genome_downsampler_tpu_torch.testing.mesh_worker import spawn_ranks

    out, kernel_launches = {"card": report}, {"blocked_sweep": 0, "dense_sweep": 0}
    reg = default_registry()
    batch = config4_batch()
    W, B, L = SHARDED_W_LOCAL, SHARDED_BLOCK, 256

    # (a) world size 1 over NCCL
    if not initialize_distributed(num_processes=1, process_id=0, device=dev):
        raise AssertionError("a process group was already up")
    try:
        mesh = global_window_mesh(dev)
        if mesh.backend != "nccl" or mesh.wire.type != "cuda":
            raise AssertionError(f"world size 1 runs {mesh.backend} on {mesh.wire}")

        def blocked(stats):
            return solve_blocked_on_mesh(mesh, batch.start, batch.end, C4_GENOME, C4_M,
                                         W, B, L, stats=stats)

        blocked({})  # warm-up
        stats = {}
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sel4 = blocked(stats)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        launches = read_launches()
        expect_launches(launches, "blocked_sweep")
        if launches["blocked_sweep"] != stats["rounds"]:
            raise AssertionError(f"{launches} for {stats['rounds']} rounds")
        kernel_launches["blocked_sweep"] += launches["blocked_sweep"]
        picked = reconstruct_selection(batch.start, batch.end,
                                       sel4[:C4_GENOME].astype(np.int64))
        t0 = time.perf_counter()
        host = reg.get("mcp-cpu").solve(C4_M, batch)
        host_s = time.perf_counter() - t0
        if not np.array_equal(picked, host):
            raise AssertionError(f"blocked mesh read set differs from mcp-cpu "
                                 f"({len(picked)} vs {len(host)})")
        check_valid(dev, batch, picked, C4_M)
        solver = reg.get("mcp-cuda")
        solver.solve(C4_M, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve(C4_M, batch)
        torch.cuda.synchronize()
        cuda_s = time.perf_counter() - t0
        out["blocked_mesh_config4"] = {
            "ranks": 1, "backend": "nccl", "W_local": W, "B": B, "L": L,
            "launches": launches["blocked_sweep"], "solve_s": mesh_s,
            "mcp_cuda_s": cuda_s, "mcp_cuda_rounds": solver.inner.last_stats["rounds"],
            "mcp_cpu_s": host_s, **stats}
        log(f"  (a) blocked mesh, 1 rank over NCCL, config-4 (W_local={W}, B={B}, L={L}): "
            f"read set == mcp-cpu ({len(picked)} reads), coverage valid; {stats['rounds']} "
            f"rounds, {launches['blocked_sweep']} kernel B launches, {stats['host_syncs']} "
            f"host syncs; warm solve to per-end counts {mesh_s:.4f} s vs mcp-cuda "
            f"(blocked engine, {solver.inner.last_stats['rounds']} rounds, to read "
            f"indices) {cuda_s:.4f} s, mcp-cpu {host_s:.4f} s  [{report}]")
        del host, picked

        for label, (pairs, n, m) in (("config-1", C1), ("edge", EDGE)):
            b = uniform_batch(pairs, n)
            target, rows = _dense_inputs(b, n, m, L, dev)
            z = torch.zeros((1, L), dtype=torch.int32, device=dev)
            ref = sweep.dense_sweep_counts(rows, target, z, z, L)[0][0].cpu().numpy()
            del target, rows
            solve_on_mesh(mesh, b.start, b.end, n, m, L)  # warm-up
            stats = {}
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sel = solve_on_mesh(mesh, b.start, b.end, n, m, L, stats=stats)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = read_launches()
            expect_launches(launches, "dense_sweep")
            if launches["dense_sweep"] != 1 or not np.array_equal(sel, ref):
                raise AssertionError(f"dense mesh at {label}: launches {launches}, sel "
                                     f"equal {np.array_equal(sel, ref)}")
            kernel_launches["dense_sweep"] += 1
            out[f"dense_mesh_{label}"] = {"ranks": 1, "n": n, "solve_s": dt,
                                          "launches": 1, **stats}
            log(f"  (a) dense mesh, 1 rank over NCCL, {label} ({n} bases): sel == kernel "
                f"A on the whole genome, 1 launch, warm solve {dt:.4f} s  [{report}]")
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # (b) two ranks on the one card over gloo
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        rcs, logs, res = spawn_ranks("dryrun", 2, Path(d) / "dry", device="cuda",
                                     timeout=300)
        if any(rcs):
            raise AssertionError(f"2-rank dry run failed: {rcs}\n"
                                 + "\n".join(t[-3000:] for t in logs))
        out["dryrun_2_ranks"] = {k: int(v) for k, v in res[0].items() if k != "seconds"}
        log(f"  (b) entry.dryrun_multichip, 2 ranks over gloo on one card, L=32: both "
            f"engines == the sequential sweep; rounds dense "
            f"{out['dryrun_2_ranks']['dense_rounds']}, blocked "
            f"{out['dryrun_2_ranks']['blocked_rounds']}")
        t0 = time.perf_counter()
        rcs, logs, res = spawn_ranks(
            "blocked_mesh", 2, Path(d) / "c4", device="cuda", timeout=600,
            params={"n": C4_GENOME, "m": C4_M, "w_local": W // 2, "block": B,
                    "max_span": L},
            arrays={"start": batch.start, "end": batch.end})
        wall = time.perf_counter() - t0
        if any(rcs):
            raise AssertionError(f"2-rank blocked mesh failed: {rcs}\n"
                                 + "\n".join(t[-3000:] for t in logs))
        for r in res:
            if not np.array_equal(r["sel"], sel4):
                raise AssertionError("2-rank blocked mesh sel differs from 1 rank's")
        st = [json.loads(str(r["stats"])) for r in res]
        out["blocked_mesh_config4_2_ranks"] = {
            "ranks": 2, "backend": "gloo", "W_local": W // 2, "wall_s": wall,
            "rank_s": [float(r["seconds"]) for r in res], "per_rank": st}
        log(f"  (b) blocked mesh, 2 ranks x {W // 2} windows over gloo on one card, "
            f"config-4: sel == 1 rank's; {st[0]['rounds']} rounds; rank 0 sent "
            f"{st[0]['messages']} messages ({st[0]['wire_bytes']} bytes), "
            f"{st[0]['host_copy_bytes']} bytes across PCIe, {st[0]['host_syncs']} host "
            f"syncs; ranks' job time (cold: pack, solve, gather) "
            + ", ".join(f"{float(r['seconds']):.3f}" for r in res)
            + f" s; {wall:.1f} s with process start  [{report}]")
    del batch, sel4

    # (c) the CLI, BAM -> BAM
    pairs, n, m = SHARDED_CLI
    with tempfile.TemporaryDirectory() as d:
        src = Path(d) / "in.bam"
        t0 = time.perf_counter()
        indexed_bam(src, bounded_pairs(pairs, n, MAX_INSERT))
        log(f"  (c) {2 * pairs} reads over {n} bases (pairs within {MAX_INSERT} bases), "
            f"BAM and BAI written in {time.perf_counter() - t0:.1f} s")
        flags = ["-l", "0", "-q", "0"]
        runs = [("mcp-cpu", ["-a", "mcp-cpu"], 1), ("mcp-cuda", ["-a", "mcp-cuda"], 1),
                ("mcp-cuda --sharded", ["-a", "mcp-cuda", "--sharded"], 1),
                ("mcp-cuda --sharded, 2 processes", ["-a", "mcp-cuda", "--sharded"], 2)]
        cli = {}
        for i, (name, a, procs) in enumerate(runs):
            dst = Path(d) / f"out{i}.bam"
            wall, laps = cli_ranks([str(src), str(m), "-o", str(dst), *a, *flags], procs)
            same = same_records(dst, Path(d) / "out0.bam") if i else "file"
            if i >= 2:
                same = same_records(dst, Path(d) / "out1.bam") + "/" + same
            cli[name] = {"wall_s": wall, "laps": laps, "equal": same}
            log(f"  (c) CLI {' '.join(a)} x {procs}: {wall:.3f} s (processes, incl. "
                f"start-up); equal to mcp-cuda/mcp-cpu: {same}"
                + "".join(f"; rank {r} laps " + ", ".join(
                    f"{k} {v:.4f}" for k, v in lp["laps_s"].items())
                    + f" s ({lp['engine']}, {lp.get('rounds')} rounds)"
                    for r, lp in sorted(laps.items()))
                + f"  [{report}]")
        out["cli_mcp"] = {"reads": 2 * pairs, "n": n, "M": m, "runs": cli}

        qp, qn, qm = SHARDED_QMCP
        src = Path(d) / "q.bam"
        indexed_bam(src, bounded_pairs(qp, qn, MAX_INSERT))
        cli = {}
        for i, procs in enumerate((1, 2)):
            dst = Path(d) / f"q{i}.bam"
            wall, laps = cli_ranks([str(src), str(qm), "-o", str(dst), "-a", "qmcp-cuda",
                                    "--sharded", *flags], procs)
            same = same_records(dst, Path(d) / "q0.bam") if i else "file"
            cli[f"qmcp-cuda --sharded x {procs}"] = {"wall_s": wall, "laps": laps,
                                                     "equal": same}
            log(f"  (c) CLI -a qmcp-cuda --sharded x {procs} ({2 * qp} reads over {qn} "
                f"bases, M={qm}): {wall:.3f} s; equal to 1 process: {same}"
                + "".join(f"; rank {r} laps " + ", ".join(
                    f"{k} {v:.4f}" for k, v in lp["laps_s"].items()) + " s"
                    for r, lp in sorted(laps.items()))
                + f"  [{report}]")
        out["cli_qmcp"] = {"reads": 2 * qp, "n": qn, "M": qm, "runs": cli}
    return out, kernel_launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke test of the port on one GPU.")
    ap.add_argument("--against", action="append", default=[], metavar="OTHER.cu",
                    help="time kernel A, B, B's wide path, C, the SSP kernel, the "
                         "variants or the ablation (by the C entries OTHER.cu defines) "
                         "against another version of its source, in turns "
                         "(phases 1 and 2 only); may repeat")
    args = ap.parse_args(argv)

    import torch

    from genome_downsampler_tpu_torch.device import gpu_report, require_cuda
    from genome_downsampler_tpu_torch.ops import build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    dev = require_cuda()
    report = gpu_report()
    t_start = time.perf_counter()
    t_phase = [t_start]

    def phase(title):
        now = time.perf_counter()
        if len(t_phase) > 1:
            log(f"  (phase wall time {now - t_phase[-1]:.1f} s)")
        t_phase.append(now)
        if title:
            log(title)

    phase("[1] probe")
    log(f"  card: {report}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    against = start_against_builds(args.against) if args.against else None
    build.build_kernels(force=True)
    log(f"  kernels built from source in {build.build_seconds:.1f} s "
        f"(nvcc {' '.join(build.NVCC_FLAGS)}, one process per source)")
    build.load_kernels()
    libs = finish_against_builds(against) if against else {}

    t0 = time.perf_counter()
    batch = config4_batch()
    c4 = config4_inputs(dev, batch)
    log(f"  config-4 data: {C4_READS} reads, {C4_GENOME} bases, W={c4['W']} B={c4['B']} "
        f"L={c4['L']} cap={c4['p32'].shape[2]} nbw={c4['p32'].shape[0]} "
        f"({time.perf_counter() - t0:.1f} s to make and pack)")

    phase("[2] kernel B (blocked sweep) vs plain twin")
    entries = [phase_sweep(dev, c4, report)]
    if libs:
        phase("[2b] kernels against other versions of their sources, in turns")
        turns = phase_turns(dev, c4, libs, report)
        phase(None)
        print(json.dumps({"turns": turns, "blocked_sweep": entries[0], "card": report}))
        return 0
    phase("[3] kernel C (selection) vs plain twin and argsort engine")
    entries.append(phase_select(dev, c4, report))
    phase("[3b] kernel B's wide path and kernel C at long spans vs plain twins")
    wide, sel_err = phase_wide_sweep(dev, c4, report)
    entries[1]["max_abs_err"] = max(entries[1]["max_abs_err"], sel_err)
    del c4
    torch.cuda.empty_cache()
    phase("[3c] the wide path's main path: mcp-cuda-blocked on midnight-30kb, long-5mb "
          "and artic-deep-30kb")
    wide["long_reads"] = long = phase_long_reads(dev, report)
    wide["launches"] = long["long-5mb"]["launches"]["blocked_sweep_wide"]
    wide["max_abs_err"] = max(wide["max_abs_err"], *(v["max_abs_err"] for v in long.values()))
    entries[1]["max_abs_err"] = max(entries[1]["max_abs_err"],
                                    *(v["select_max_abs_err"] for v in long.values()))
    for v in long.values():
        v["launches"] = v["launches"]["blocked_sweep_wide"]
    phase("[4] main path at config-4 through mcp-cuda (blocked engine)")
    launches, host4 = phase_main_path(dev, batch, report)
    for ent in entries:
        ent["launches"] = launches[ent["name"]]
    entries.append(wide)
    phase("[5] CLI BAM -> BAM")
    phase_cli(report)
    phase("[6] kernel A (dense sweep) vs plain twin")
    dense = phase_dense_kernel(dev, report)
    entries.insert(0, dense)
    phase("[7] dense main path through mcp-cuda")
    path_launches, err7, path_ms = phase_dense_path(dev, report)
    dense["launches"] = path_launches["config-1"]
    dense["edge_ms"] = path_ms["edge"]
    dense["edge_bound_ms"] = dense_bound(1, EDGE[1], 256)[0]
    dense["edge_launches"] = path_launches["edge"]
    phase(f"[8] windowed solver, W={WINDOWS}, at config-4")
    (err8, dense["windowed_round_ms"], dense["windowed_round_bound_ms"],
     dense["windowed_launches"]) = phase_windowed(batch, host4, report)
    del batch, host4
    torch.cuda.empty_cache()
    phase("[9] solve_batch over 8 samples")
    err9 = phase_batched(report)
    dense["max_abs_err"] = max(dense["max_abs_err"], err7, err8, err9)
    phase("[10] qmcp-sweep-cuda at config-1")
    phase_qmcp(dev, report)
    torch.cuda.empty_cache()
    phase("[11] kernel A's variants C and B (kernel_variants)")
    entries += phase_variants(dev, report)
    phase("[12] the blocked sweep's ablation (bench_kernel_ablate)")
    b_ns = next(e for e in entries if e["name"] == "blocked_sweep")[
        "full_pass_ns_per_position"]
    entries.append(phase_ablate(dev, report, b_ns))
    torch.cuda.empty_cache()
    phase("[13] the SSP kernel vs plain twin")
    ssp_entry = phase_ssp_kernel(dev, report)
    entries.append(ssp_entry)
    phase("[14] qmcp-cuda vs qmcp-cpu: config-1, 32,768 and 65,536 bases, the edge, "
          "above the limit")
    qmcp = phase_qmcp_exact(dev, report)
    ssp_entry["launches"] = qmcp["config-1"]["launches"]
    ssp_entry["solves"] = qmcp
    phase("[15] profiler: device busy share of warm solves")
    ssp_entry["busy_share"] = phase_profile(dev, report)
    torch.cuda.empty_cache()
    phase("[16] quasi-mcp-flow-cuda (push-relabel, torch ops on the card): the "
          "3,000-base cut, config-1, 1M pairs over 30 kb")
    phase_push_relabel(dev, report)
    torch.cuda.empty_cache()
    phase("[17] the mesh engines and --sharded on the card")
    sharded, mesh_launches = phase_sharded(dev, report)
    dense["sharded_launches"] = mesh_launches["dense_sweep"]
    next(e for e in entries if e["name"] == "blocked_sweep")["sharded_launches"] = (
        mesh_launches["blocked_sweep"])
    print(json.dumps({"sharded": sharded}))
    phase(None)
    log(f"  total wall time {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": entries}))
    print(report)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
