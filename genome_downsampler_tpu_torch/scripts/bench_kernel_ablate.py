"""Per-step cost attribution of the blocked sweep's step, on the card.

    python -m genome_downsampler_tpu_torch.scripts.bench_kernel_ablate [reads_M] [W[:B]] ...

Counterpart of the JAX package's ``scripts/bench_kernel_ablate.py``, at
its size: ``reads_M`` million reads (default 6.0) of 150 bp with sorted
uniform starts (seed 7) over n = 2.5 x reads positions, M = 30, L = 256,
each ``W:B`` geometry (default ``64:128``; B defaults to 256) packed with
chunk 128 for B <= 128 and 256 above. Times each of the seven modes of
``ops/ablate.py`` (the least of 5 launches after one warm launch) and
prints ms and ns per step (one position of all W windows). Only ``full``
is a correct sweep: its ``out`` is checked against kernel A run over the
head of each window's arrival rows from zero carries (``match=``), and its
``out`` and carries against kernel B (``blocked_sweep_pass``: targets
given, zero carries, grid offset 0) on the same codes (``match_b=``); no
read of the default has span L, so the two compute the same function.
``full`` and kernel B are then timed side by side, in turns (full, B, B,
full). Last, the pieces of the step in ns per step (``pieces_ns``): take
= full - notake, shift = full - noroll, emit = full - noemit, fold =
addonly - emptyloop, handover = emptyloop - tileonly.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from genome_downsampler_tpu_torch import _native
from genome_downsampler_tpu_torch.device import gpu_report, require_cuda
from genome_downsampler_tpu_torch.ops.ablate import MODES, blocked_ablate
from genome_downsampler_tpu_torch.ops.blocked import blocked_sweep_pass
from genome_downsampler_tpu_torch.ops.sweep import dense_sweep_counts
from genome_downsampler_tpu_torch.scripts import best_ms

READ_LEN, MAX_SPAN, MAX_COVERAGE, SEED = 150, 256, 30, 7
CHECK_POSITIONS = 4096  # positions per window ``full`` is held to kernel A on


def problem(reads_m, seed=SEED):
    """``(start, end, n)``: sorted uniform starts of ``reads_m`` million
    reads over ``2.5 x`` as many positions."""
    n_reads = int(reads_m * 1e6)
    n = int(n_reads * 2.5)
    rng = np.random.default_rng(seed)
    start = rng.integers(0, n - READ_LEN, n_reads, dtype=np.int64)
    start.sort(kind="stable")
    return start, start + READ_LEN - 1, n


def pack(start, end, n, W, B, max_span, max_coverage, device):
    """``(packed[nbw, W, cap], counts[nbw, W], target[W, win])`` int32 on
    ``device``, packed with chunk 128 for ``B <= 128`` and 256 above, and
    ``win``."""
    packed, counts, win, n_pad, _ = _native.pack_blocked(
        start, end, n, W, B, max_span, cap_multiple=128 if B <= 128 else 256
    )
    target = _native.capped_target(start, end, n_pad, max_coverage).reshape(W, win)
    return (*(torch.tensor(x, device=device) for x in (packed, counts, target)), win)


def window_rows(start, end, win, W, head, max_span, device):
    """Arrival rows ``[W, head, L]`` of the first ``head`` positions of each
    window, each window's reads alone."""
    w, j = start // win, start % win
    keep = j < head
    idx = ((w * head + j) * max_span + (end - start))[keep]
    rows = torch.zeros(W * head * max_span, dtype=torch.int32, device=device)
    rows.index_add_(0, torch.as_tensor(idx, device=device),
                    torch.ones(idx.shape[0], dtype=torch.int32, device=device))
    return rows.reshape(W, head, max_span)


def pieces_ns(res):
    """The step's pieces in ns per step from ``run``'s results at one
    geometry: ``{"take", "shift", "emit", "fold", "handover"}``."""
    ns = {m: res[m]["ns_per_step"] for m in MODES}
    return {"take": ns["full"] - ns["notake"], "shift": ns["full"] - ns["noroll"],
            "emit": ns["full"] - ns["noemit"], "fold": ns["addonly"] - ns["emptyloop"],
            "handover": ns["emptyloop"] - ns["tileonly"]}


def run(device, reads_m=6.0, geometries=((64, 128),), *, reps=5, log=print):
    """Time the seven modes at each ``(W, B)``; returns ``{(W, B): {"win",
    "packed", "counts", "target", "kernel_a", "match", "kernel_b", "match_b",
    "turns", "pieces_ns", mode: {"ms", "ns_per_step", "out"}}}``. ``match``
    holds ``full``'s ``out`` against ``kernel_a``, kernel A over the first
    ``CHECK_POSITIONS`` positions of every window; ``match_b`` its ``out``
    and carries against kernel B on the same codes, ``kernel_b`` (``{"ms",
    "ns_per_step"}``) the lesser of kernel B's turns, ``turns`` ``{"full":
    [ms, ms], "kernel_b": [ms, ms]}`` in the order full, B, B, full."""
    dev = torch.device(device)
    start, end, n = problem(reads_m)
    log(f"{start.shape[0]} reads / {n / 1e6:.1f} Mb")
    L = MAX_SPAN
    results = {}
    for W, B in geometries:
        packed, counts, target, win = pack(start, end, n, W, B, L, MAX_COVERAGE, dev)
        nbw, _, cap = packed.shape
        log(f"W={W} B={B}: cap={cap} nbw={nbw} packed={4 * packed.numel() / 1e6:.0f}MB")
        res = results[(W, B)] = {"win": win, "packed": packed, "counts": counts,
                                 "target": target}
        for mode in MODES:
            got, ms = best_ms(
                lambda: blocked_ablate(packed, target, W, B, L, mode), dev, reps
            )
            res[mode] = {"ms": ms, "ns_per_step": 1e6 * ms / win, "out": got[0]}
            if mode == "full":
                full = got
            log(f"  {mode:9s}: {ms:9.3f} ms = {1e6 * ms / win:7.1f} ns/step")
        z = torch.zeros((W, L), dtype=torch.int32, device=dev)
        runs = {"full": lambda: blocked_ablate(packed, target, W, B, L, "full"),
                "kernel_b": lambda: blocked_sweep_pass(packed, counts, target, z, z, W,
                                                       B, L)}
        turns = res["turns"] = {"full": [], "kernel_b": []}
        for who in ("full", "kernel_b", "kernel_b", "full"):
            got, ms = best_ms(runs[who], dev, reps)
            turns[who].append(ms)
            log(f"  turn {who:8s}: {ms:9.3f} ms = {1e6 * ms / win:7.1f} ns/step")
            if who == "kernel_b":
                kernel_b = got[:3]  # out, availf, selendf
        kb = min(turns["kernel_b"])
        res["kernel_b"] = {"ms": kb, "ns_per_step": 1e6 * kb / win}
        res["match_b"] = all(torch.equal(a, b) for a, b in zip(full, kernel_b))
        res["pieces_ns"] = pieces_ns(res)
        log("  pieces (ns/step): " + ", ".join(
            f"{k} {v:.1f}" for k, v in res["pieces_ns"].items()))
        head = min(win, CHECK_POSITIONS)
        rows = window_rows(start, end, win, W, head, L, dev)
        ref = dense_sweep_counts(rows, target[:, :head].contiguous(), z, z, L)[0]
        res["kernel_a"] = ref
        res["match"] = torch.equal(res["full"]["out"][:, :head], ref)
        log(f"  full == kernel B on the same codes: match_b={res['match_b']}; "
            f"full == kernel A over the first {head} positions of the {W} "
            f"windows: match={res['match']}")
    return results


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    reads_m = float(argv[0]) if argv else 6.0
    geometries = []
    for a in argv[1:]:
        w, _, b = a.partition(":")
        geometries.append((int(w), int(b) if b else 256))
    dev = require_cuda()
    print(gpu_report(), flush=True)
    results = run(dev, reads_m, geometries or [(64, 128)],
                  log=lambda *a: print(*a, flush=True))
    if not all(r["match"] and r["match_b"] for r in results.values()):
        raise SystemExit("full differs from kernel A or kernel B")


if __name__ == "__main__":
    main()
