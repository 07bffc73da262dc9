"""Config-5 on the card: 100M reads of 150 bp over 250 Mb (human chr1's
shape), M = 30, generated, packed, solved and checked on the device.

    python -m genome_downsampler_tpu_torch.scripts.bench_chr1 [reads_millions] [M]
    python -m genome_downsampler_tpu_torch.scripts.bench_chr1 --qmcp [reads_millions] [M]

Counterpart of the JAX package's ``scripts/bench_chr1.py``, at its size
(N = 250,000,000, W = 64 windows, B = 128, L = 256, CAP = 128). Read ``i``
starts at ``((i * 2654435761) mod 2^32) mod (N - 149)``; the card receives
no read data. On the card: the pack kernel (``ops.device_pack.pack_reads``:
reads generated and bucketed into (block, window) groups, each group's
codes ascending, with counts, and the coverage difference), the capped
target ``min(coverage, M)``, the blocked solve
(``ops.blocked.blocked_windowed_sweep``: kernel B, one seed pass and a
pass a relaxation round), and the checks: coverage at least the target at
every base (a window sum of the per-end counts over ``[p, p + 149]``) and
the per-end counts equal to those of the host greedy
(``native_greedy_select``) run on the same reads made on the host, whose
read count the solve's must equal. Prints each lap and a JSON line of the
numbers; exits non-zero if a check fails. Needs a card and raises without
one.

``--qmcp`` is the exact quality-weighted solve at chromosome scale, on the
host only, as in the JAX script: the C++ convex-bucket MCMF
(``mcmf_select_convex``) over a genome of ``reads * 150 / 60`` bases (60x,
at most N), with Weyl MAPQs 0..60 and costs ``61 - q``, then the validity
check.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from genome_downsampler_tpu_torch.device import resolve_device
from genome_downsampler_tpu_torch.ops import device_pack
from genome_downsampler_tpu_torch.ops.blocked import blocked_windowed_sweep
from genome_downsampler_tpu_torch.scripts import probe_main, sync
from genome_downsampler_tpu_torch.solvers.native_greedy import native_greedy_select
from genome_downsampler_tpu_torch.solvers.native_mcmf import mcmf_select_convex

N = 250_000_000
READ_LEN = 150
M = 30
W, B, L, CAP = 64, 128, 256, 128
READS = 100_000_000
# blocks a window that blocked_windowed_sweep's seed pass sweeps
SEED_BLOCKS = 8
WEYL = np.uint32(2654435761)
WEYL_Q = np.uint32(2246822519)


def host_starts(r: int, n: int = N) -> np.ndarray:
    """The starts of the ``r`` Weyl reads over ``n`` bases, int64, as the
    card makes them."""
    i = np.arange(r, dtype=np.uint32)
    return ((i * WEYL) % np.uint32(n - READ_LEN + 1)).astype(np.int64)


def host_quality(r: int) -> np.ndarray:
    """Pseudo-random MAPQ stream 0..60, reproducible like ``host_starts``."""
    i = np.arange(r, dtype=np.uint32)
    h = i * WEYL_Q
    h ^= h >> 15
    h = h * np.uint32(2654435761)
    h ^= h >> 13
    return (h % np.uint32(61)).astype(np.int64)


def covers_target(sel: torch.Tensor, target: torch.Tensor, read_len: int = READ_LEN) -> bool:
    """Coverage at least the target at every base, on ``sel``'s device: with
    one span, the selected coverage at ``p`` is the sum of the per-end
    counts ``sel`` over ``[p, p + read_len - 1]`` (cut at the end)."""
    c = torch.cumsum(sel, 0, dtype=torch.int32)
    cs = torch.cat([c.new_zeros(1), c, c[-1:].expand(read_len - 1)])
    return bool(torch.all(cs[read_len:] - cs[:sel.numel()] >= target.reshape(-1)))


def run(device, reads: int, m: int, *, n: int = N, windows: int = W, log=print) -> dict:
    """Config-5's pipeline on ``device`` (the kernels on a card, their plain
    twins on the CPU) for ``reads`` reads at M = ``m``; ``n`` and
    ``windows`` shrink the problem for the CPU tests. Returns the numbers:
    geometry, ``selected`` against ``oracle``, ``valid``, ``per_end_equal``
    and ``first_difference`` (position, solve, oracle), ``rounds``,
    ``passes`` (kernel B's, the seed pass included), ``fill``, the laps in
    seconds and, on a card, ``memory_peak_bytes``; ``ok`` when the count,
    validity and per-end checks hold."""
    dev = resolve_device(device)
    win, nbw, n_pad = device_pack.geometry(n, windows, B)
    log(f"n={n} reads={reads} M={m} W={windows} win={win} nbw={nbw} n_pad={n_pad}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    laps = {}

    def lap(name, t0):
        sync(dev)
        laps[name] = time.perf_counter() - t0
        return time.perf_counter()

    t = time.perf_counter()
    s_host = host_starts(reads, n)
    e_host = s_host + READ_LEN - 1
    t = lap("host_gen", t)
    oracle = native_greedy_select(s_host, e_host, n, m)
    t = lap("host_greedy", t)
    log(f"host gen {laps['host_gen']:.3f} s, host C++ greedy {laps['host_greedy']:.3f} s: "
        f"selected={len(oracle)}")

    packed, counts, diff, fill = device_pack.pack_reads(
        reads, n, windows, dev, block=B, span=L, cap=CAP, read_len=READ_LEN)
    t = lap("gen_pack", t)
    target = device_pack.capped_target(diff, m, windows)
    del diff
    t = lap("target", t)
    sel, rounds = blocked_windowed_sweep(packed, counts, target, windows, B, L,
                                         seed_blocks=SEED_BLOCKS)
    t = lap("solve", t)
    del packed, counts
    selected = int(sel.sum(dtype=torch.int64))
    valid = covers_target(sel, target)
    ends = torch.as_tensor(e_host[oracle], device=dev)
    per_end = torch.bincount(ends, minlength=n_pad).to(torch.int32)
    differ = torch.nonzero(sel != per_end)
    first = None
    if differ.numel():
        p = int(differ[0, 0])
        first = {"position": p, "sel": int(sel[p]), "oracle": int(per_end[p])}
    lap("check", t)
    passes = rounds + int(SEED_BLOCKS > 0 and windows > 1 and nbw > SEED_BLOCKS)
    log(f"device gen+pack {laps['gen_pack']:.3f} s (max group fill {fill}, cap {CAP}), "
        f"target {laps['target']:.3f} s, solve {laps['solve']:.3f} s ({rounds} rounds, "
        f"{passes} passes), check {laps['check']:.3f} s")
    res = {
        "n": n, "reads": reads, "M": m, "W": windows, "B": B, "L": L, "CAP": CAP,
        "win": win, "nbw": nbw, "n_pad": n_pad, "device": str(dev),
        "selected": selected, "oracle": len(oracle), "valid": valid,
        "per_end_equal": first is None, "first_difference": first,
        "rounds": rounds, "passes": passes, "fill": fill, "laps": laps,
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
    }
    res["ok"] = selected == len(oracle) and valid and first is None
    log(f"selected {selected} (host oracle {len(oracle)}), coverage valid {valid}, "
        f"per-end counts equal {first is None}" + (f" (first difference {first})"
                                                   if first else ""))
    return res


def run_qmcp(reads: int, m: int, *, log=print) -> dict:
    """The exact weighted QMCP on the host (``--qmcp``): ``n = min(N,
    reads * 150 / 60)``; returns ``n``, ``selected``, ``cost``, ``valid``
    and the laps in seconds."""
    n = min(N, reads * READ_LEN // 60)
    log(f"QMCP: n={n} reads={reads} M={m} (~60x coverage)")
    t0 = time.perf_counter()
    s = host_starts(reads, n)
    e = s + READ_LEN - 1
    cost = 60 - host_quality(reads) + 1
    t1 = time.perf_counter()
    sel = mcmf_select_convex(s, e, cost, n, m)
    t2 = time.perf_counter()
    d = np.bincount(s, minlength=n + 1)
    d[1:] -= np.bincount(e, minlength=n + 1)[:n]
    ds = np.bincount(s[sel], minlength=n + 1)
    ds[1:] -= np.bincount(e[sel], minlength=n + 1)[:n]
    valid = bool(np.all(np.minimum(np.cumsum(d[:n]), m) <= np.cumsum(ds[:n])))
    laps = {"host_gen": t1 - t0, "solve": t2 - t1, "check": time.perf_counter() - t2}
    res = {"n": n, "reads": reads, "M": m, "selected": len(sel),
           "cost": int(cost[sel].sum()), "valid": valid, "laps": laps}
    log(f"exact weighted QMCP (host SSP MCMF): {laps['solve']:.3f} s "
        f"selected={res['selected']} cost={res['cost']}; coverage valid {valid}")
    return res


def _args(argv):
    r = int(float(argv[0]) * 1e6) if argv else READS
    return r, int(argv[1]) if len(argv) > 1 else M


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if "--qmcp" in argv:
        res = run_qmcp(*_args([a for a in argv if a != "--qmcp"]),
                       log=lambda *a: print(*a, flush=True))
        print(json.dumps(res), flush=True)
        if not res["valid"]:
            raise SystemExit("QMCP selection leaves coverage below the capped target")
        return
    probe_main(run, *_args(argv))


if __name__ == "__main__":
    main()
