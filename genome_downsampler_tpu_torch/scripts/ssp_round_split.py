"""Where a fixpoint round of the SSP kernel spends its time.

    python -m genome_downsampler_tpu_torch.scripts.ssp_round_split SOURCE.cu [...]

Each SOURCE is a version of ``ops/csrc/ssp.cu``: the port's, or an earlier
one written out with ``git show <commit>:genome_downsampler_tpu_torch/ops/
csrc/ssp.cu`` (the one-CTA kernel before the cooperative grid). The script
writes an instrumented copy under ``build/ssp_split/``: thread 0 of CTA 0
reads its SM's cycle counter (``clock64``) at the start of each round and
after each of its parts, and adds the differences up. It builds the copy
with ``nvcc``, runs it once at config-1 (25,000 pairs of 150 bp over 29,903
bases, M=100) and at the QMCP edge (109,583 pairs over 131,072 bases), and
prints each part's share of the rounds' cycles and the microseconds that
share is of the launch's time (CUDA events) divided by its rounds (one
launch each, so a first launch's costs fall in it). The
parts: one-CTA kernel: closure (both scans), forward side, backward side,
``changed`` (``__syncthreads_or``); the grid kernel: the round's first
barrier with its aggregates and carry folds ("top"), closure (the rest of
both scans, barrier 2 among them), forward side and backward side (a
snapshot, a barrier and the relax each; ``changed`` is part of the
backward side's block or). Needs a CUDA card; the port's own kernel is
untouched (the copy is a separate library). Ends with one JSON line.

    python -m genome_downsampler_tpu_torch.scripts.ssp_round_split --floors 128,256,512

times the port's kernel (uninstrumented; the least of 3 launches by CUDA
events) at the same two cells with the grid cut at each chunk floor
in place of ``ops.ssp.CHUNK_FLOOR``, each bit-equal to the port's floor.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "ssp_split"
# (pairs, genome, M) of 150 bp reads with uniform starts from seed 12345
CELLS = {"config-1": (25_000, 29_903, 100), "QMCP edge": (109_583, 131_072, 100)}
# the one-CTA kernel's entry: (bstart, bend1, off0, cap, pool, run_lo,
# run_hi, excess0, flow, scalars, ws, n, B, R, phase_cap, stream)
ONE_CTA_SIGNATURE = [ctypes.c_void_p] * 11 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]

_STAMP = ("{{ if (blockIdx.x == 0 && threadIdx.x == 0) {{ const long long t_ = clock64(); "
          "{acc}gd_split_last = t_; }} }}")
# per version: the round loop's first line, then the line after which
# each part ends, and the parts' names
VERSIONS = {
    "one-CTA": (r"while \(changed && it < it_cap\) \{",
                [r"chain_closure\(net, s, sh\);", r"bool imp = relax_side\(net, s, 3\);",
                 r"imp = relax_side\(net, s, 4\) \|\| imp;",
                 r"changed = __syncthreads_or\(imp\) != 0;"],
                ["closure", "forward side", "backward side", "changed"]),
    "grid": (r"for \(;;\) \{",
             [r"if \(!changed \|\| it == it_cap\) break;",
              r"closure_up\(ch, ef, ek\);\s*__syncthreads\(\);",
              r"bool imp = relax_side\(ch, ch.tabF, ch.cntF, g.dbufF, 3\);\s*__syncthreads\(\);",
              r"my_chg = __syncthreads_or\(imp\);"],
             ["top", "closure", "forward side", "backward side"]),
}
_HEADER = """
__device__ long long gd_split_acc[8];
__device__ long long gd_split_last;
extern "C" int gd_split_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, gd_split_acc, sizeof(gd_split_acc));
}
extern "C" int gd_split_reset() {
  long long z[8] = {0};
  return (int)cudaMemcpyToSymbol(gd_split_acc, z, sizeof(z));
}
"""


def instrument(text: str):
    """(instrumented source, version, part names) of an ``ssp.cu`` text."""
    version = "grid" if "cudaLaunchCooperativeKernel" in text else "one-CTA"
    start, ends, names = VERSIONS[version]
    m = re.search(start, text)
    if m is None:
        raise ValueError(f"no round loop ({start}) in the {version} source")
    text = text[:m.end()] + _STAMP.format(acc="") + text[m.end():]
    for k, pat in enumerate(ends):
        m = re.search(pat, text)
        if m is None:
            raise ValueError(f"no {pat} in the {version} source")
        acc = f"gd_split_acc[{k}] += t_ - gd_split_last; "
        text = text[:m.end()] + _STAMP.format(acc=acc) + text[m.end():]
    # the counters at file scope, after the includes
    at = text.index("namespace {")
    return text[:at] + _HEADER + text[at:], version, names


def build(source: Path, tag: str) -> ctypes.CDLL:
    from genome_downsampler_tpu_torch.ops import build as kbuild

    OUT.mkdir(parents=True, exist_ok=True)
    text, _, _ = instrument(source.read_text())
    cu = OUT / f"{tag}.cu"
    cu.write_text(text)
    lib = OUT / f"lib{tag}.so"
    cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-shared", "-o", str(lib), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise kbuild.KernelBuildError(f"{' '.join(cmd)}\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def one_cta_launch(lib, arrays, phase_cap):
    """One launch of the one-CTA kernel's entry on CUDA tensors (``ssp_solve``'s
    inputs); returns what ``ssp_solve`` returns."""
    from genome_downsampler_tpu_torch.ops import build as kbuild

    dev = arrays[7].device
    n, B = arrays[7].shape[0] - 1, arrays[0].shape[0]
    flow = torch.empty(B, dtype=torch.int32, device=dev)
    scalars = torch.empty(4, dtype=torch.int32, device=dev)
    ws = torch.empty(11 * (n + 2), dtype=torch.int32, device=dev)
    kbuild.check("gd_ssp_solve", lib.gd_ssp_solve(
        *(a.data_ptr() for a in arrays), flow.data_ptr(), scalars.data_ptr(),
        ws.data_ptr(), n, B, arrays[4].shape[0], phase_cap,
        torch.cuda.current_stream(dev).cuda_stream))
    return (flow, *scalars.tolist())


def split(lib, version, names, arrays, cap):
    """Run ``lib`` once on ``arrays``; the parts' shares and us a round."""
    from genome_downsampler_tpu_torch.ops import ssp

    dev = arrays[0].device
    lib.gd_split_reset()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = (one_cta_launch(lib, arrays, cap) if version == "one-CTA"
           else ssp.launch(lib, *arrays, cap))
    end.record()
    torch.cuda.synchronize(dev)
    ms, rounds = start.elapsed_time(end), out[4]
    acc = (ctypes.c_longlong * 8)()
    lib.gd_split_read(acc)
    cyc = list(acc)[:len(names)]
    total = sum(cyc)
    return out, {
        "ms": ms, "rounds": rounds, "us_per_round": 1e3 * ms / rounds,
        "parts": {k: {"share": c / total, "us_per_round": 1e3 * ms / rounds * c / total}
                  for k, c in zip(names, cyc)},
    }


def main(argv=None) -> int:
    from genome_downsampler_tpu_torch.device import gpu_report, require_cuda
    from genome_downsampler_tpu_torch.ops import build as kbuild
    from genome_downsampler_tpu_torch.testing.reads_gen import rand_reads_uniform
    from genome_downsampler_tpu_torch.testing.ssp_cases import quality_cost, ssp_network

    args = list(sys.argv[1:] if argv is None else argv)
    floors = []
    if "--floors" in args:
        at = args.index("--floors")
        floors = [int(f) for f in args[at + 1].split(",")]
        del args[at:at + 2]
    sources = [Path(p) for p in args]
    if not sources and not floors:
        print(__doc__, file=sys.stderr)
        return 2
    dev = require_cuda()
    report = gpu_report()
    kbuild.load_kernels()  # ops.build.check reads the port's error strings
    nets = {}
    for cell, (pairs, n, m) in CELLS.items():
        b = rand_reads_uniform(np.random.default_rng(12345), pairs, n, 150)
        arrays, supply = ssp_network(b.start, b.end, quality_cost(b.quality), n, m)
        nets[cell] = ([a.to(dev) for a in arrays], supply + 16)
    result = {"card": report, "sources": {}}
    for i, src in enumerate(sources):
        t0 = time.perf_counter()
        _, version, names = instrument(src.read_text())
        lib = build(src, f"split{i}")
        fn = lib.gd_ssp_solve
        fn.restype = ctypes.c_int
        fn.argtypes = (ONE_CTA_SIGNATURE if version == "one-CTA"
                       else kbuild._SIGNATURES["gd_ssp_solve"])
        lib.gd_split_read.argtypes = [ctypes.c_void_p]
        per = {}
        for cell, (arrays, cap) in nets.items():
            out, per[cell] = split(lib, version, names, arrays, cap)
            print(f"{src} ({version}) at {cell}: {per[cell]['ms']:.1f} ms, "
                  f"{out[4]} rounds, {per[cell]['us_per_round']:.2f} us a round: "
                  + ", ".join(f"{k} {v['share']:.1%} ({v['us_per_round']:.2f} us)"
                              for k, v in per[cell]["parts"].items())
                  + f"  [{report}]", flush=True)
        result["sources"][str(src)] = {"version": version, "cells": per,
                                       "seconds": time.perf_counter() - t0}
    if floors:
        result["floors"] = chunk_floors(floors, nets, report)
    print(json.dumps(result))
    return 0


def chunk_floors(floors, nets, report):
    """The port's kernel, uninstrumented, with the grid cut at each chunk
    floor in ``floors`` in place of ``ops.ssp.CHUNK_FLOOR``: bit-equal to
    the floor the port uses, the least of 3 launches (CUDA events)."""
    from genome_downsampler_tpu_torch.ops import build as kbuild
    from genome_downsampler_tpu_torch.ops import ssp
    from genome_downsampler_tpu_torch.scripts import best_ms

    lib, floor0, out = kbuild.load_kernels(), ssp.CHUNK_FLOOR, {}
    try:
        for cell, (arrays, cap) in nets.items():
            ref = ssp.launch(lib, *arrays, cap)
            dev = arrays[0].device
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            for f in floors:
                ssp.CHUNK_FLOOR = f
                G, C = ssp.grid_shape(arrays[7].shape[0] - 1, sms)
                got, ms = best_ms(lambda: ssp.launch(lib, *arrays, cap), dev, 3)
                ssp.CHUNK_FLOOR = floor0
                if not torch.equal(got[0], ref[0]) or got[1:] != ref[1:]:
                    raise AssertionError(f"chunk floor {f} differs from {floor0} at {cell}")
                out.setdefault(cell, {})[f] = {"ctas": G, "chunk": C, "ms": ms,
                                               "us_per_round": 1e3 * ms / got[4]}
                print(f"chunk floor {f} at {cell}: {G} CTAs of {C} nodes, {ms:.1f} ms, "
                      f"{1e3 * ms / got[4]:.2f} us a round  [{report}]", flush=True)
    finally:
        ssp.CHUNK_FLOOR = floor0
    return out


if __name__ == "__main__":
    sys.exit(main())
