"""The production solver against the host greedy, cold and warm.

    python -m genome_downsampler_tpu_torch.scripts.bench_e2e_quick [reads_M] [--seed S]

Counterpart of the JAX package's ``scripts/bench_e2e_quick.py``: 6M reads
of 150 bp with uniform sorted starts over 15 Mb (2.5 bases a read), M =
30, from ``--seed`` (12345). The host greedy (``NativeGreedyMcpSolver``)
cold and warm, then ``McpDeviceSweepSolver`` on the card (the dense
engine up to 262,144 bases, the blocked engine above) cold and twice warm
on the same reads, each warm solve beside a warm host greedy; its
``last_stats`` (engine and laps). Each solve's read set must equal the
host greedy's, index for index. Prints the laps and a JSON line of the
numbers; exits non-zero if a check fails. Needs a card and raises without
one.
"""

from __future__ import annotations

import argparse
import time

from genome_downsampler_tpu_torch.device import resolve_device
from genome_downsampler_tpu_torch.scripts import (
    probe_main,
    read_batch,
    same_read_set,
    sorted_uniform_reads,
)
from genome_downsampler_tpu_torch.solvers.device_sweep import McpDeviceSweepSolver
from genome_downsampler_tpu_torch.solvers.native_greedy import NativeGreedyMcpSolver

READS = 6_000_000
M = 30
SEED = 12345
WARM = 2


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def run(device, reads: int = READS, *, seed: int = SEED, log=print) -> dict:
    """The solves on ``device`` (the kernels on a card, their twins on the
    CPU). Returns the shape, the host's cold and warm seconds, the
    device's cold solve and each warm rep (seconds, the host's warm
    seconds beside it, their ratio, ``read_set_equal``), the solver's
    ``stats`` and ``ok``."""
    dev = resolve_device(device)
    n = int(reads * 2.5)
    batch = read_batch(*sorted_uniform_reads(reads, n, seed), n)
    log(f"{reads} reads / {n / 1e6:.1f} Mb / M={M}")
    host = NativeGreedyMcpSolver()
    host_sel, host_cold = _timed(host.solve, M, batch)
    host_sel, host_warm = _timed(host.solve, M, batch)
    log(f"host cold: {host_cold:.3f}s warm: {host_warm:.3f}s selected={len(host_sel)}")

    solver = McpDeviceSweepSolver(dev)
    sel, cold = _timed(solver.solve, M, batch)
    cold_equal = same_read_set(sel, host_sel)
    log(f"device cold: {cold:.3f}s selected={len(sel)} read set equal {cold_equal}")
    warm = []
    for rep in range(WARM):
        sel, dev_s = _timed(solver.solve, M, batch)
        host_sel, host_s = _timed(host.solve, M, batch)
        warm.append({"rep": rep, "device_s": dev_s, "host_s": host_s,
                     "device_vs_host": host_s / dev_s,
                     "read_set_equal": same_read_set(sel, host_sel)})
        log(f"rep{rep}: device e2e {dev_s:.3f}s vs host warm {host_s:.3f}s -> "
            f"device_vs_host {host_s / dev_s:.2f} read set equal "
            f"{warm[-1]['read_set_equal']}; {solver.last_stats}")
    return {
        "reads": reads, "n": n, "M": M, "seed": seed, "device": str(dev),
        "selected": len(sel), "oracle": len(host_sel), "host_cold_s": host_cold,
        "host_warm_s": host_warm, "device_cold_s": cold, "cold_read_set_equal": cold_equal,
        "warm": warm, "stats": solver.last_stats,
        "ok": cold_equal and all(w["read_set_equal"] for w in warm),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("reads_m", nargs="?", type=float, default=READS / 1e6)
    ap.add_argument("--seed", type=int, default=SEED)
    args = ap.parse_args(argv)
    probe_main(run, int(args.reads_m * 1e6), seed=args.seed)


if __name__ == "__main__":
    main()
