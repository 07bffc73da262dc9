#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit (``nvcc``). It imports nothing of JAX and nothing of the JAX
package's device code. Phases, each of which raises on failure:

1. probe: the card (``nvidia-smi`` name and power limit), torch / CUDA
   versions; build the kernels from ``genome_downsampler_tpu_torch/ops/
   csrc`` and report the build time;
2. kernel B (blocked sweep) == its plain torch twin on the card, on a small
   geometry and on the config-4 solve's own packed codes (W=32, B=128,
   L=256), with and without auto_target, a grid offset and seeded carries;
   time one full config-4 pass and the kernel vs the twin on a tail slice;
3. kernel C (selection) == its twin == the argsort engine, at config-4;
4. the main path at config-4 scale (10M reads of 150 bp, uniform starts
   over 5 Mb, M=50: 300x -> 50x) through ``default_registry().get(
   "mcp-cuda")``: read set equal to ``mcp-cpu`` (the host C++ greedy),
   coverage valid at every base, both kernels launched; phase laps and the
   warm end-to-end time beside the host greedy's;
5. CLI BAM -> BAM (200k reads over 30 kb, M=100) with ``-a mcp-cuda`` and
   ``-a mcp-cpu``: the same records.

Integer results must match exactly (tolerance 0). The next-to-last line
is a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``. Exits non-zero,
printing neither line, without a CUDA device or outside the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 12345
C4_READS, C4_GENOME, C4_M, READ_LEN = 10_000_000, 5_000_000, 50, 150
TAIL_BLOCKS = 4  # blocks per window the plain sweep twin is timed on


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=1):
    """Mean device-timeline milliseconds of ``fn`` over ``reps`` runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


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

    from genome_downsampler_tpu.core.readbatch import ReadBatch

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


def phase_sweep(dev, c4, report):
    """Kernel B against its twin; returns the kernel's JSON entry."""
    import numpy as np
    import torch

    from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform
    from genome_downsampler_tpu_torch import _native
    from genome_downsampler_tpu_torch.ops import blocked

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
    full_ms = cuda_ms(lambda: blocked.blocked_sweep_pass(p32, cnt, None, z, z, W, B, L, **kw), 5)
    tail_ms = cuda_ms(lambda: blocked.blocked_sweep_pass(
        p32, cnt, None, z, z, W, B, L, grid_offset=tail, **kw), 5)
    plain_ms = cuda_ms(lambda: blocked.blocked_sweep_pass_plain(
        p32, cnt, None, z, z, W, B, L, grid_offset=tail, **kw), 1)
    pos_full = nbw * B
    pos_tail = TAIL_BLOCKS * B
    log(f"  kernel B full config-4 pass: {full_ms:.3f} ms for {pos_full} positions "
        f"x {W} windows ({1e6 * full_ms / pos_full:.1f} ns/position)")
    log(f"  tail slice ({pos_tail} positions x {W} windows): kernel {tail_ms:.3f} ms "
        f"({1e6 * tail_ms / pos_tail:.1f} ns/position), plain twin {plain_ms:.3f} ms "
        f"({1e6 * plain_ms / pos_tail:.1f} ns/position)  [{report}]")
    return {
        "name": "blocked_sweep", "route": "cuda",
        "source": "genome_downsampler_tpu_torch/ops/csrc/blocked_sweep.cu",
        "replaces": "genome_downsampler_tpu/ops/pallas_blocked.py:383",
        "max_abs_err": max(errs), "ms": tail_ms, "plain_ms": plain_ms,
        "timed_on": f"tail slice: {TAIL_BLOCKS} blocks x {W} windows, auto_target",
        "full_pass_ms": full_ms,
    }


def phase_select(dev, c4, report):
    """Kernel C against its twin and the argsort engine at config-4."""
    import torch

    from genome_downsampler_tpu_torch.ops import blocked
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
    ms = cuda_ms(lambda: blocked.blocked_selection_pass(p32, cnt, sel, xwin, W, B, L), 5)
    plain_ms = cuda_ms(
        lambda: blocked.blocked_selection_pass_plain(p32, cnt, sel, xwin, W, B, L), 1
    )
    log(f"  kernel C full config-4 pass: {ms:.3f} ms, plain twin {plain_ms:.3f} ms "
        f"[{report}]")
    return {
        "name": "blocked_select", "route": "cuda",
        "source": "genome_downsampler_tpu_torch/ops/csrc/blocked_select.cu",
        "replaces": "genome_downsampler_tpu/ops/pallas_blocked.py:704",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "timed_on": f"full config-4 pass: {p32.shape[0]} blocks x {W} windows",
    }


def phase_main_path(dev, batch, report):
    """mcp-cuda through the registry at config-4, against mcp-cpu."""
    import numpy as np
    import torch

    from genome_downsampler_tpu.solvers.native_greedy import NativeGreedyMcpSolver
    from genome_downsampler_tpu_torch.ops import blocked
    from genome_downsampler_tpu_torch.ops.coverage import (
        coverage_from_intervals,
        coverage_is_valid,
    )
    from genome_downsampler_tpu_torch.solvers.registry import default_registry

    reg = default_registry()
    solver = reg.get("mcp-cuda")
    solver.solve(C4_M, batch)  # warm-up: library load, allocator, clocks
    blocked.blocked_sweep_pass.launches = 0
    blocked.blocked_selection_pass.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sel = solver.solve(C4_M, batch)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = {
        "blocked_sweep": blocked.blocked_sweep_pass.launches,
        "blocked_select": blocked.blocked_selection_pass.launches,
    }
    stats = solver.inner.last_stats

    t0 = time.perf_counter()
    host = reg.get("mcp-cpu").solve(C4_M, batch)
    host_s = time.perf_counter() - t0
    assert isinstance(reg.get("mcp-cpu").inner, NativeGreedyMcpSolver)
    if not np.array_equal(sel, host):
        raise AssertionError(
            f"mcp-cuda read set differs from mcp-cpu ({len(sel)} vs {len(host)})"
        )
    s = torch.tensor(batch.start, device=dev)
    e = torch.tensor(batch.end, device=dev)
    cov_in = coverage_from_intervals(s, e, batch.ref_genome_length)
    cov_out = coverage_from_intervals(s[torch.tensor(sel, device=dev)],
                                      e[torch.tensor(sel, device=dev)],
                                      batch.ref_genome_length)
    if not coverage_is_valid(cov_in, cov_out, C4_M):
        raise AssertionError("min(cov_in, M) <= cov_out fails somewhere")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path was not launched: {launches}")
    log(f"  mcp-cuda == mcp-cpu: {len(sel)} of {batch.n_reads} reads selected; "
        f"coverage valid at all {batch.ref_genome_length} bases")
    log(f"  launches in the timed solve: {launches}")
    log(f"  last_stats: {json.dumps(stats)}")
    log(f"  warm end-to-end mcp-cuda solve {e2e:.4f} s vs host C++ greedy "
        f"(mcp-cpu) {host_s:.4f} s  [{report}]")
    return launches


def phase_cli(report):
    """BAM -> BAM through the port's CLI with mcp-cuda and mcp-cpu."""
    import numpy as np

    from genome_downsampler_tpu.config import BamApiConfig
    from genome_downsampler_tpu.io.bam import read_bam
    from genome_downsampler_tpu.testing.bam_writer import write_test_bam_fast
    from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform

    rng = np.random.default_rng(SEED)
    batch = rand_reads_uniform(rng, 100_000, 30_000, 150)
    with tempfile.TemporaryDirectory() as d:
        src = Path(d) / "in.bam"
        write_test_bam_fast(src, batch)
        outs = {}
        for algo in ("mcp-cuda", "mcp-cpu"):
            out = Path(d) / f"{algo}.bam"
            t0 = time.perf_counter()
            subprocess.run(
                [sys.executable, "-m", "genome_downsampler_tpu_torch", str(src),
                 "100", "-o", str(out), "-a", algo, "-l", "0", "-q", "0"],
                cwd=ROOT, check=True, timeout=600,
            )
            log(f"  CLI -a {algo}: {time.perf_counter() - t0:.3f} s (process, incl. start-up)")
            outs[algo] = out
        cfg = BamApiConfig(min_seq_length=0, min_mapq=0)
        a, _, _ = read_bam(outs["mcp-cuda"], cfg)
        b, _, _ = read_bam(outs["mcp-cpu"], cfg)
        same = a.n_reads == b.n_reads and all(
            np.array_equal(getattr(a, f), getattr(b, f))
            for f in ("start", "end", "quality", "bam_id")
        )
        if not same:
            raise AssertionError("CLI outputs of mcp-cuda and mcp-cpu differ")
        identical = outs["mcp-cuda"].read_bytes() == outs["mcp-cpu"].read_bytes()
        log(f"  CLI outputs hold the same {a.n_reads} records of {batch.n_reads} "
            f"(byte-identical files: {identical})  [{report}]")


def main() -> int:
    import numpy as np
    import torch

    from genome_downsampler_tpu_torch import _native
    from genome_downsampler_tpu_torch.device import gpu_report, require_cuda
    from genome_downsampler_tpu_torch.ops import blocked, build
    from genome_downsampler_tpu_torch.solvers.blocked_sweep import (
        BlockedWindowedMcpSolver,
        _cross_window_offsets,
    )

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    dev = require_cuda()
    report = gpu_report()
    log("[1] probe")
    log(f"  card: {report}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    build.build_kernels(force=True)
    log(f"  kernels built from source in {build.build_seconds:.1f} s "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    build.load_kernels()

    t0 = time.perf_counter()
    batch = config4_batch()
    W, B, L, chunk = BlockedWindowedMcpSolver("cuda")._geometry(
        C4_GENOME, READ_LEN, C4_READS * READ_LEN / C4_GENOME
    )
    flat, counts, win, n_pad, cap, _ = _native.pack_flat_direct(
        batch.start, batch.end, C4_GENOME, W, B, L, cap_multiple=chunk,
        cap_floor=2 * chunk,
    )
    counts_d = torch.tensor(counts, device=dev)
    c4 = {
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
    log(f"  config-4 data: {C4_READS} reads, {C4_GENOME} bases, W={W} B={B} L={L} "
        f"cap={cap} nbw={win // B} ({time.perf_counter() - t0:.1f} s to make and pack)")

    log("[2] kernel B (blocked sweep) vs plain twin")
    entries = [phase_sweep(dev, c4, report)]
    log("[3] kernel C (selection) vs plain twin and argsort engine")
    entries.append(phase_select(dev, c4, report))
    del c4
    log("[4] main path at config-4 through mcp-cuda")
    launches = phase_main_path(dev, batch, report)
    for ent in entries:
        ent["launches"] = launches[ent["name"]]
    del batch
    log("[5] CLI BAM -> BAM")
    phase_cli(report)

    print(json.dumps({"kernels": entries}))
    print(report)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
