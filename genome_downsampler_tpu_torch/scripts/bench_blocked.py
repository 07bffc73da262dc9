"""Kernel B's pass and the relaxed blocked solve alone, at 30 kb and 5 Mb.

    python -m genome_downsampler_tpu_torch.scripts.bench_blocked [sars|ecoli|ecoli-small]

Counterpart of the JAX package's ``scripts/bench_blocked.py``, at its
scales: ``sars`` 1M pairs of 150 bp over 30 kb, M = 1000; ``ecoli`` 8.35M
pairs over 5 Mb, M = 50; ``ecoli-small`` 2M pairs over 5 Mb, M = 25; all
from seed 12345 at W = 8 windows, B = 256, L = 256. ``scripts.time_blocked``
packs on the host (``_native.pack_blocked``), builds the capped target,
and times one kernel B pass from zero carries and the relaxed solve
(``blocked_windowed_sweep``: a seed pass, then a pass a round) by CUDA
events, warm repeats on the same inputs, the least of ``reps``. The read
set (``reconstruct_selection``) must equal the host greedy's
(``NativeGreedyMcpSolver``), index for index, and cover ``min(coverage,
M)`` at every base. Prints the laps and a JSON line of the numbers; exits
non-zero if a check fails. Needs a card and raises without one.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from genome_downsampler_tpu_torch.device import resolve_device
from genome_downsampler_tpu_torch.scripts import probe_main, time_blocked
from genome_downsampler_tpu_torch.solvers.native_greedy import NativeGreedyMcpSolver
from genome_downsampler_tpu_torch.testing.coverage_tester import _coverage, is_out_cover_valid
from genome_downsampler_tpu_torch.testing.reads_gen import rand_reads_uniform

# scale: (pairs, genome, read length, M)
SCALES = {
    "sars": (1_000_000, 30_000, 150, 1000),
    "ecoli": (8_350_000, 5_000_000, 150, 50),
    "ecoli-small": (2_000_000, 5_000_000, 150, 25),
}
SEED = 12345
L = 256


def run(device, scale: str = "sars", *, n_windows: int = 8, block: int = 256,
        pairs: int | None = None, genome: int | None = None, reps: int = 3,
        log=print) -> dict:
    """One scale on ``device`` (kernel B on a card, its twin on the CPU);
    ``pairs`` and ``genome`` cut it. Returns the geometry, the pass's and
    the solve's ms, the rounds, ``selected`` against ``oracle``,
    ``read_set_equal``, ``valid``, the laps in seconds and ``ok``."""
    if scale not in SCALES:
        raise ValueError(f"unknown scale {scale!r}; one of {sorted(SCALES)}")
    dev = resolve_device(device)
    p0, n0, read_len, m = SCALES[scale]
    pairs, n = pairs or p0, genome or n0
    t = time.perf_counter()
    batch = rand_reads_uniform(np.random.default_rng(SEED), pairs, n, read_len)
    start = np.asarray(batch.start, np.int64)
    end = np.asarray(batch.end, np.int64)
    laps = {"gen": time.perf_counter() - t}
    log(f"{scale}: {batch.n_reads} reads over {n} bases, M={m} (gen {laps['gen']:.2f} s)")

    t = time.perf_counter()
    host_sel = NativeGreedyMcpSolver().solve(m, batch)
    laps["host_greedy"] = time.perf_counter() - t
    log(f"host C++ greedy: {laps['host_greedy']:.3f} s selected={len(host_sel)}")

    res, dev_sel = time_blocked(dev, start, end, n, m, n_windows, block, L, host_sel,
                                reps=reps, log=log)
    solve = res.pop("solves")["seed8"]
    laps.update({k: res.pop(k) for k in ("pack_s", "target_s", "upload_s")})
    valid = is_out_cover_valid(_coverage(batch), _coverage(batch, dev_sel), m)
    log(f"read set equal to the host greedy's: {solve['exact']}; coverage valid: {valid}; "
        f"{batch.n_reads / solve['ms'] / 1e3:.1f}M reads/s (solve only)")
    return {
        "scale": scale, "pairs": pairs, "reads": batch.n_reads, "n": n, "M": m, **res,
        "device": str(dev), "solve_ms": solve["ms"], "rounds": solve["rounds"],
        "selected": solve["selected"], "oracle": len(host_sel),
        "read_set_equal": solve["exact"], "valid": valid, "laps": laps,
        "ok": solve["exact"] and valid,
    }


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    probe_main(run, argv[0] if argv else "sars")


if __name__ == "__main__":
    main()
