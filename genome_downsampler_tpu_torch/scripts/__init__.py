"""The port's counterparts of the JAX package's root scripts:

    python -m genome_downsampler_tpu_torch.scripts.kernel_variants
    python -m genome_downsampler_tpu_torch.scripts.bench_kernel_ablate [reads_M] [W[:B]] ...
    python -m genome_downsampler_tpu_torch.scripts.bench_chr1 [reads_M] [M]
    python -m genome_downsampler_tpu_torch.scripts.bench_kernel [pairs_M]
    python -m genome_downsampler_tpu_torch.scripts.bench_io [pairs_M]
    python -m genome_downsampler_tpu_torch.scripts.bench_blocked [sars|ecoli|ecoli-small]
    python -m genome_downsampler_tpu_torch.scripts.bench_config4_probe [reads_M] [n_Mb] [M] [reps]
    python -m genome_downsampler_tpu_torch.scripts.bench_e2e_quick [reads_M] [--seed S]
    python -m genome_downsampler_tpu_torch.scripts.bench_w_scaling [reads_M] [W[:B] ...]
    python -m genome_downsampler_tpu_torch.scripts.bench_sharded_qmcp [reads_M]
    bash genome_downsampler_tpu_torch/scripts/run_asan.sh

Each but the last needs a CUDA card and raises without one. Each exposes
``run(device, ...)``, which the CPU tests drive with the plain twins at a
small size. ``run_asan.sh`` runs ``asan_exercise.py`` by path under
AddressSanitizer; that file imports no torch.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from genome_downsampler_tpu_torch import _native
from genome_downsampler_tpu_torch.core.readbatch import ReadBatch
from genome_downsampler_tpu_torch.ops.blocked import blocked_sweep_pass, blocked_windowed_sweep
from genome_downsampler_tpu_torch.solvers.device_sweep import reconstruct_selection

READ_LEN = 150


def best_ms(fn, device, reps: int = 5, *, warm: bool = True):
    """``(fn(), ms)``: one warm call (unless ``warm`` is false), then the
    least of ``reps`` timed calls. On a CUDA ``device`` the calls are
    queued back to back between CUDA events, with one synchronize at the
    end, so a call's time is the device's from one event to the next and
    the host's launch overhead hides behind the queued work; on the CPU it
    is the host clock."""
    out = fn() if warm else None
    if torch.device(device).type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        events[0].record()
        for e in events[1:]:
            out = fn()
            e.record()
        torch.cuda.synchronize()
        times = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    else:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return out, min(times)


def sync(device) -> None:
    """Wait for the card's queued work (nothing on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def same_read_set(got, want) -> bool:
    """The two read index arrays hold the same reads, index for index."""
    return np.array_equal(np.sort(np.asarray(got, np.int64)),
                          np.sort(np.asarray(want, np.int64)))


def sorted_uniform_reads(reads: int, n: int, seed: int):
    """``reads`` reads of ``READ_LEN`` bases with uniform sorted starts over
    ``n`` bases, from ``seed``: ``(start, end)``, int64."""
    start = np.random.default_rng(seed).integers(0, n - READ_LEN, reads, dtype=np.int64)
    start.sort(kind="stable")
    return start, start + READ_LEN - 1


def read_batch(start, end, n: int, quality=None) -> ReadBatch:
    """The reads ``start, end`` over ``n`` bases as a ``ReadBatch`` of
    consecutive pairs (read ``2k`` the first mate), quality 60 unless
    given."""
    r = len(start)
    return ReadBatch(
        bam_id=np.arange(r, dtype=np.int64), start=start, end=end,
        quality=np.full(r, 60, np.int32) if quality is None else quality,
        seq_length=(np.asarray(end) - np.asarray(start) + 1).astype(np.int32),
        is_first=np.arange(r) % 2 == 0, ref_genome_length=n,
    )


def time_blocked(device, start, end, n: int, m: int, W: int, B: int, L: int, oracle, *,
                 seeds=(8,), cap_multiple: int = 256, reps: int = 3, log=print):
    """Kernel B's pass and the relaxed solve alone on these reads. The host
    packs them (``_native.pack_blocked``) and builds the capped target
    (``_native.capped_target``); after the upload, one kernel B pass from
    zero carries (``blocked_sweep_pass``) and, for each seed-block count of
    ``seeds``, the solve (``blocked_windowed_sweep``) are timed by
    ``best_ms``. Each solve's per-end counts go to read indices by
    ``reconstruct_selection`` and are held against ``oracle`` index for
    index. Returns ``(numbers, read indices of the last solve)``: the
    geometry, the host laps in seconds, the pass's ms and ns a position,
    and per seed-block count ``seed<k>``'s ms, rounds, ``selected`` and
    ``exact``."""
    t0 = time.perf_counter()
    packed, counts, win, n_pad, _ = _native.pack_blocked(start, end, n, W, B, L,
                                                         cap_multiple=cap_multiple)
    pack_s = time.perf_counter() - t0
    nbw, _, cap = packed.shape
    log(f"W={W} B={B} L={L}: pack {pack_s:.3f} s cap={cap} nbw={nbw} win={win} "
        f"packed={packed.nbytes / 1e6:.1f} MB")
    t0 = time.perf_counter()
    target = _native.capped_target(start, end, n_pad, m).reshape(W, win)
    target_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # torch.tensor copies: nothing on the device aliases the pack arenas
    packed_d = torch.tensor(packed, device=device)
    counts_d = torch.tensor(counts, device=device)
    target_d = torch.tensor(target, device=device)
    sync(device)
    upload_s = time.perf_counter() - t0
    z = torch.zeros((W, L), dtype=torch.int32, device=device)
    _, pass_ms = best_ms(lambda: blocked_sweep_pass(packed_d, counts_d, target_d, z, z,
                                                    W, B, L), device, reps)
    log(f"  target {target_s:.3f} s, upload {upload_s:.3f} s; pass (warm, least of {reps}): "
        f"{pass_ms:.3f} ms = {1e6 * pass_ms / win:.1f} ns/position ({win} positions)")
    solves, sel = {}, None
    for sb in seeds:
        (counts_out, rounds), ms = best_ms(lambda: blocked_windowed_sweep(
            packed_d, counts_d, target_d, W, B, L, seed_blocks=sb), device, reps)
        sel = reconstruct_selection(start, end, counts_out[:n].cpu().numpy())
        exact = same_read_set(sel, oracle)
        solves[f"seed{sb}"] = {"ms": ms, "rounds": rounds, "selected": len(sel),
                               "exact": exact}
        log(f"  solve seed{sb} (warm, least of {reps}): {ms:.3f} ms rounds={rounds} "
            f"selected={len(sel)} exact={exact}")
    return {"W": W, "B": B, "L": L, "cap": cap, "nbw": nbw, "win": win,
            "packed_mb": packed.nbytes / 1e6, "pack_s": pack_s, "target_s": target_s,
            "upload_s": upload_s, "pass_ms": pass_ms, "ns_per_position": 1e6 * pass_ms / win,
            "solves": solves}, sel


def probe_main(run, *args, **kw) -> dict:
    """A probe's ``main``: on the card (raises without one), the card's
    line, then ``run(device, *args, log=..., **kw)``'s laps as it goes and
    its JSON last; exits non-zero unless the result is ``ok``."""
    from genome_downsampler_tpu_torch.device import gpu_report, require_cuda

    dev = require_cuda()

    def log(*a):
        print(*a, flush=True)

    log(gpu_report())
    res = run(dev, *args, log=log, **kw)
    print(json.dumps(res), flush=True)
    if not res["ok"]:
        raise SystemExit(f"{run.__module__}: a check failed")
    return res
