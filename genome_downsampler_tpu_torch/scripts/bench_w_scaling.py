"""Kernel B against the window count W: pass time and relaxation rounds at
``bench.py``'s 25M-read headline shape.

    python -m genome_downsampler_tpu_torch.scripts.bench_w_scaling [reads_M] [W[:B] ...] \\
        [--cov X] [--m M] [--seeds 0,8] [--seed S]

Counterpart of the JAX package's ``scripts/bench_w_scaling.py``: 25M reads
of 150 bp with uniform sorted starts over ``reads * 150 / cov`` bases (60x:
62.5 Mb), M = 30, from ``--seed`` (12345), at W in {8, 16, 32}; B is 256
up to W = 16, else 128, unless a ``W:B`` pair sets it; L = 256. For each W:
``scripts.time_blocked``'s host pack (``_native.pack_blocked``, caps a
multiple of 256 at B = 256, else 128) and its time; the capped target on
the host; one kernel B pass from zero carries (ms and ns a position, CUDA
events, warm, the least of ``reps``); then for each ``--seeds`` value the
relaxed solve (``blocked_windowed_sweep`` with that many seed blocks: ms,
rounds) and whether its read set (``reconstruct_selection``) equals the
host greedy's index for index.
Prints the laps and a JSON line of the numbers; exits non-zero if a check
fails. Needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import time

from genome_downsampler_tpu_torch.device import resolve_device
from genome_downsampler_tpu_torch.scripts import (
    READ_LEN,
    probe_main,
    sorted_uniform_reads,
    time_blocked,
)
from genome_downsampler_tpu_torch.solvers.native_greedy import native_greedy_select

READS = 25_000_000
WS = ((8, None), (16, None), (32, None))
COV, M, SEEDS, SEED = 60.0, 30, (0, 8), 12345
L = 256


def run(device, reads: int = READS, ws=WS, *, cov: float = COV, m: int = M, seeds=SEEDS,
        seed: int = SEED, reps: int = 2, log=print) -> dict:
    """Each ``(W, B or None)`` of ``ws`` on ``device`` (kernel B on a card,
    its twin on the CPU). Returns the shape, the host greedy's seconds and
    count, and per W ``scripts.time_blocked``'s numbers: its geometry, host
    laps, the pass's ms and ns a position, and per seed-block count the
    solve's ms, rounds, ``selected`` and ``exact``; ``ok`` when every solve
    is exact."""
    dev = resolve_device(device)
    n = int(reads * READ_LEN / cov)
    t0 = time.perf_counter()
    start, end = sorted_uniform_reads(reads, n, seed)
    log(f"gen {reads} reads / {n / 1e6:.1f} Mb: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    host_sel = native_greedy_select(start, end, n, m)
    host_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_sel = native_greedy_select(start, end, n, m)
    host_warm = time.perf_counter() - t0
    log(f"host C++ greedy: {host_cold:.3f}s, warm {host_warm:.3f}s, selected={len(host_sel)}")

    out = []
    for W, B_opt in ws:
        B = B_opt or (256 if W <= 16 else 128)
        res, _ = time_blocked(dev, start, end, n, m, W, B, L, host_sel, seeds=seeds,
                              cap_multiple=256 if B >= 256 else 128, reps=reps, log=log)
        out.append(res)
    return {"reads": reads, "n": n, "M": m, "cov": cov, "seed": seed, "L": L,
            "device": str(dev), "host_greedy_s": host_cold, "host_greedy_warm_s": host_warm,
            "oracle": len(host_sel), "ws": out,
            "ok": all(s["exact"] for w in out for s in w["solves"].values())}


def parse_ws(args) -> tuple:
    """``["8", "32:256"]`` -> ``((8, None), (32, 256))``."""
    return tuple((int(a.split(":")[0]), int(a.split(":")[1]) if ":" in a else None)
                 for a in args)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("reads_m", nargs="?", type=float, default=READS / 1e6)
    ap.add_argument("ws", nargs="*", metavar="W[:B]")
    ap.add_argument("--cov", type=float, default=COV)
    ap.add_argument("--m", type=int, default=M)
    ap.add_argument("--seeds", default=",".join(map(str, SEEDS)))
    ap.add_argument("--seed", type=int, default=SEED)
    a = ap.parse_args(argv)
    probe_main(run, int(a.reads_m * 1e6), parse_ws(a.ws) or WS, cov=a.cov, m=a.m,
               seeds=tuple(int(x) for x in a.seeds.split(",")), seed=a.seed)


if __name__ == "__main__":
    main()
