"""Kernel A against its variants C and B on one row, on the card.

    python -m genome_downsampler_tpu_torch.scripts.kernel_variants

Counterpart of the JAX package's ``scripts/kernel_variants.py``, at its
size: 1,000,000 pairs of 150 bp reads over 30,000 bases (seed 12345),
padded to a multiple of 4096 reads, n = 30,208 positions, L = 256,
M = 1000. Rows and target are built on the card; the reference is the
port's ``sweep_counts``. Times kernel A (``dense_sweep_counts``, one row),
then variant C, then variant B (rows rotated beforehand, outside the
timed launches), each the least of 5 launches after one warm launch, and
prints ``match=`` for each against the reference; then each kernel's ns
per position and the two differences A - C (what keeping the prefix scan
of the ring on the step's chain costs C, negative when C is slower) and
C - B (the shift of C's ring against B's fixed ring, whose owner lane of
the expiring slot moves). All three run on one frame (one CTA of a sweep
warp and three producer warps), so the differences are the steps'.
"""

from __future__ import annotations

import numpy as np
import torch

from genome_downsampler_tpu_torch.testing.reads_gen import rand_reads_uniform
from genome_downsampler_tpu_torch.device import gpu_report, require_cuda
from genome_downsampler_tpu_torch.ops.coverage import (
    capped_coverage,
    coverage_from_intervals,
)
from genome_downsampler_tpu_torch.ops.sweep import dense_sweep_counts
from genome_downsampler_tpu_torch.ops.variants import (
    rotate_rows,
    sweep_variant_b,
    sweep_variant_c,
)
from genome_downsampler_tpu_torch.scripts import best_ms
from genome_downsampler_tpu_torch.solvers.device_sweep import (
    build_start_rows,
    sweep_counts,
)

PAIRS, GENOME, READ_LEN, SEED = 1_000_000, 30_000, 150, 12345
N, MAX_SPAN, MAX_COVERAGE = 30_208, 256, 1000


def problem(device, pairs=PAIRS, genome=GENOME, read_len=READ_LEN, n=N,
            max_span=MAX_SPAN, max_coverage=MAX_COVERAGE, seed=SEED):
    """``(rows[n, L], target[n])`` int32 on ``device``: the arrival rows and
    the capped coverage of the seeded reads, padded slots weighted 0."""
    batch = rand_reads_uniform(np.random.default_rng(seed), pairs, genome, read_len)
    arrays, valid = batch.padded(4096)
    start = torch.as_tensor(arrays["start"], device=device)
    end = torch.as_tensor(arrays["end"], device=device)
    w = torch.as_tensor(valid, device=device).to(torch.int32)
    rows = build_start_rows(start, end - start + 1, w, n, max_span)
    target = capped_coverage(coverage_from_intervals(start, end, n, w), max_coverage)
    return rows, target


def run(device, *, reps=5, log=print, **size):
    """Time kernel A, C and B on ``problem(device, **size)``; returns
    ``(results, rows, target)``: ``results`` is ``{name: {"ms", "match",
    "out"}}`` for ``A``, ``C`` and ``B``, the other two the problem."""
    dev = torch.device(device)
    rows, target = problem(dev, **size)
    n, L = rows.shape
    z = torch.zeros((1, L), dtype=torch.int32, device=dev)
    ref = sweep_counts(rows, target, z[0], z[0], L)[0]
    rows_rot = rotate_rows(rows)
    kernels = {
        "A": ("prod", lambda: dense_sweep_counts(rows[None], target[None], z, z, L)[0][0]),
        "C": ("branch-free", lambda: sweep_variant_c(rows, target, L)),
        "B": ("no-roll ring", lambda: sweep_variant_b(rows_rot, target, L)),
    }
    results = {}
    for name, (label, fn) in kernels.items():
        out, ms = best_ms(fn, dev, reps)
        match = torch.equal(out, ref)
        log(f"{name} ({label}): {ms:.3f} ms = {1e6 * ms / n:.1f} ns/position "
            f"match={match}")
        results[name] = {"ms": ms, "match": match, "out": out}
    return results, rows, target


def ns_split(results, n):
    """``{"A", "C", "B"}`` ns per position over ``n`` positions from
    ``run``'s results, and the differences ``"A-C"`` and ``"C-B"``."""
    ns = {k: 1e6 * results[k]["ms"] / n for k in ("A", "C", "B")}
    return {**ns, "A-C": ns["A"] - ns["C"], "C-B": ns["C"] - ns["B"]}


def main():
    dev = require_cuda()
    print(gpu_report(), flush=True)
    results, rows, _ = run(dev, log=lambda *a: print(*a, flush=True))
    split = ns_split(results, rows.shape[0])
    print(f"ns/position: A {split['A']:.2f}, C {split['C']:.2f}, B {split['B']:.2f}; "
          f"A - C {split['A-C']:.2f}, C - B {split['C-B']:.2f}", flush=True)
    if not all(r["match"] for r in results.values()):
        raise SystemExit("a kernel differs from the reference")


if __name__ == "__main__":
    main()
