"""Kernel A (the dense sweep) at 1M pairs over 30 kb, on the card.

    python -m genome_downsampler_tpu_torch.scripts.bench_kernel [pairs_millions]

Counterpart of the JAX package's ``scripts/bench_kernel.py``, at its case:
150 bp pairs with uniform starts over 30,000 bases from seed 12345, padded
to a multiple of 4,096 reads, the ``(n, L)`` arrival rows at n = 30,208
and L = 256 (``build_start_rows``) and the capped coverage targets at M =
1000, 999, 998 and 1001. Kernel A (``ops.sweep.dense_sweep_counts``) runs
on each target, timed by CUDA events (one warm launch, then the least of
``reps`` launches queued back to back); "matches scan" holds its per-end
counts at the first target against the plain twin (``sweep_counts``) run
on the card, and the read set they give (``reconstruct_selection``)
against the host greedy's (``native_greedy_select``) on the same reads.
Prints the laps and a JSON line of the numbers; exits non-zero if a check
fails. Needs a card and raises without one.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from genome_downsampler_tpu_torch.device import resolve_device
from genome_downsampler_tpu_torch.ops.coverage import capped_coverage, coverage_from_intervals
from genome_downsampler_tpu_torch.ops.sweep import dense_sweep_counts
from genome_downsampler_tpu_torch.scripts import best_ms, probe_main, same_read_set, sync
from genome_downsampler_tpu_torch.solvers.device_sweep import (
    build_start_rows,
    reconstruct_selection,
    sweep_counts,
)
from genome_downsampler_tpu_torch.solvers.native_greedy import native_greedy_select
from genome_downsampler_tpu_torch.testing.reads_gen import rand_reads_uniform

PAIRS = 1_000_000
GENOME = 30_000
N, L = 30_208, 256
MS = (1000, 999, 998, 1001)
SEED = 12345


def inputs(pairs: int, genome: int, n: int, dev):
    """The case's reads (start, end as int64 numpy, padded reads dropped)
    and, on ``dev``, the arrival rows and the four targets."""
    batch = rand_reads_uniform(np.random.default_rng(SEED), pairs, genome, 150)
    arrays, valid = batch.padded(4096)
    start = torch.as_tensor(arrays["start"], device=dev)
    endv = torch.as_tensor(arrays["end"], device=dev)
    w = torch.as_tensor(valid, device=dev).to(torch.int32)
    rows = build_start_rows(start, endv - start + 1, w, n, L)
    cov = coverage_from_intervals(start, endv, n, w)
    targets = [capped_coverage(cov, m).contiguous() for m in MS]
    return (np.asarray(batch.start, np.int64), np.asarray(batch.end, np.int64),
            rows, targets)


def run(device, pairs: int = PAIRS, *, genome: int = GENOME, n: int = N, reps: int = 5,
        log=print) -> dict:
    """The case on ``device`` (kernel A on a card, its twin on the CPU) for
    ``pairs`` pairs; ``genome`` and ``n`` shrink it for the CPU tests.
    Returns the geometry, ``matches_scan``, ``read_set_equal`` (``selected``
    against ``oracle``, at M = 1000), each target's ``ms`` and ns a
    position, the laps in seconds and ``ok``."""
    dev = resolve_device(device)
    laps = {}
    t = time.perf_counter()
    start, end, rows, targets = inputs(pairs, genome, n, dev)
    sync(dev)
    laps["inputs"] = time.perf_counter() - t
    log(f"{2 * pairs} reads over {genome} bases, n={n} L={L}: rows ready in "
        f"{laps['inputs']:.2f} s")
    z = torch.zeros((1, L), dtype=torch.int32, device=dev)

    def kernel(target):
        return dense_sweep_counts(rows[None], target[None], z, z, L)[0][0]

    t = time.perf_counter()
    got = kernel(targets[0])
    ref = sweep_counts(rows, targets[0], z[0], z[0], L)[0]
    matches = bool(torch.equal(got, ref))
    sync(dev)
    laps["scan"] = time.perf_counter() - t
    t = time.perf_counter()
    sel = reconstruct_selection(start, end, got[:genome].cpu().numpy())
    oracle = native_greedy_select(start, end, genome, MS[0])
    laps["read_set"] = time.perf_counter() - t
    equal = same_read_set(sel, oracle)
    log(f"matches scan: {matches}; read set at M={MS[0]} equal to the host greedy: "
        f"{equal} ({len(sel)} and {len(oracle)} reads)")
    ms = []
    for m, target in zip(MS, targets):
        ms.append(best_ms(lambda: kernel(target), dev, reps)[1])
        log(f"M={m}: {ms[-1]:.3f} ms ({1e6 * ms[-1] / n:.1f} ns/position)")
    return {
        "pairs": pairs, "reads": 2 * pairs, "genome": genome, "n": n, "L": L,
        "M": list(MS), "device": str(dev), "matches_scan": matches,
        "read_set_equal": equal, "selected": len(sel), "oracle": len(oracle),
        "ms": ms, "ns_per_position": [1e6 * x / n for x in ms], "laps": laps,
        "ok": matches and equal,
    }


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    probe_main(run, int(float(argv[0]) * 1e6) if argv else PAIRS)


if __name__ == "__main__":
    main()
