"""Config-4's blocked solve by phase: 10M reads over 5 Mb, M = 50 (300x).

    python -m genome_downsampler_tpu_torch.scripts.bench_config4_probe [reads_M] [n_Mb] [M] [reps]

Counterpart of the JAX package's ``scripts/bench_config4_probe.py``: reads
of 150 bp made in memory (no BAM), read ``i`` of rep ``k`` starting at
``((i + 7919 k) * 2654435761 mod 2^32) mod (n - 149)``, so each rep solves
other reads; for each rep the host greedy (``native_greedy_select``) and
the port's ``BlockedWindowedMcpSolver`` on the card, each timed, and the
solver's ``last_stats`` (rounds, geometry, the laps pack, h2d, sweep,
select, d2h, bit test). The solver's read set must equal the greedy's,
index for index. Prints the laps and a JSON line of the numbers; exits
non-zero if a check fails. Needs a card and raises without one.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from genome_downsampler_tpu_torch.device import resolve_device
from genome_downsampler_tpu_torch.scripts import READ_LEN, probe_main, read_batch, same_read_set
from genome_downsampler_tpu_torch.solvers.blocked_sweep import BlockedWindowedMcpSolver
from genome_downsampler_tpu_torch.solvers.native_greedy import native_greedy_select

READS = 10_000_000
N = 5_000_000
M = 50
REPS = 2
WEYL = np.uint32(2654435761)


def rep_starts(r: int, n: int, rep: int) -> np.ndarray:
    """Rep ``rep``'s starts, int64 (uint32 arithmetic, as the JAX script)."""
    i = np.arange(r, dtype=np.uint32)
    return (((i + np.uint32(rep * 7919)) * WEYL) % np.uint32(n - READ_LEN + 1)).astype(np.int64)


def run(device, reads: int = READS, n: int = N, m: int = M, reps: int = REPS, *,
        log=print) -> dict:
    """``reps`` solves on ``device`` (the kernels on a card, their twins on
    the CPU). Returns the shape and, per rep, the host greedy's and the
    solve's seconds, ``selected`` against ``oracle``, ``read_set_equal``
    and the solver's ``stats``; ``ok`` when every rep's read set is equal."""
    dev = resolve_device(device)
    log(f"shape: {reads} reads / {n} bp / M={m} (~{reads * READ_LEN / n:.0f}x)")
    out = []
    for rep in range(reps):
        s = rep_starts(reads, n, rep)
        e = s + READ_LEN - 1
        t0 = time.perf_counter()
        oracle = native_greedy_select(s, e, n, m)
        host_s = time.perf_counter() - t0
        batch = read_batch(s.astype(np.int32), e.astype(np.int32), n)
        solver = BlockedWindowedMcpSolver(dev)
        t0 = time.perf_counter()
        sel = solver.solve(m, batch)
        solve_s = time.perf_counter() - t0
        equal = same_read_set(sel, oracle)
        out.append({"rep": rep, "host_greedy_s": host_s, "solve_s": solve_s,
                    "selected": len(sel), "oracle": len(oracle), "read_set_equal": equal,
                    "stats": solver.last_stats})
        laps = ", ".join(f"{k} {v:.4f}" for k, v in solver.last_stats["phases_s"].items())
        log(f"rep{rep}: host_greedy={host_s:.3f}s device_solve={solve_s:.3f}s "
            f"selected={len(sel)} read set equal {equal}; rounds "
            f"{solver.last_stats['rounds']}, laps (s): {laps}")
    return {"reads": reads, "n": n, "M": m, "coverage": reads * READ_LEN / n,
            "device": str(dev), "reps": out,
            "ok": all(r["read_set_equal"] for r in out)}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    args = [int(float(argv[0]) * 1e6) if argv else READS,
            int(float(argv[1]) * 1e6) if len(argv) > 1 else N,
            int(argv[2]) if len(argv) > 2 else M,
            int(argv[3]) if len(argv) > 3 else REPS]
    probe_main(run, *args)


if __name__ == "__main__":
    main()
