"""Where a closure round of the push-relabel kernel spends its time.

    python -m genome_downsampler_tpu_torch.scripts.flow_round_split SOURCE.cu [...]

Each SOURCE is a version of ``ops/csrc/push_relabel.cu``: the port's, or an
earlier one written out with ``git show <commit>:genome_downsampler_tpu_torch/
ops/csrc/push_relabel.cu`` (the four-barrier round, recognised by its C
entry's 25 arguments, which takes one table row a read). The script writes
an instrumented copy under ``build/flow_split/``: thread 0 of CTA 0 reads
its SM's cycle counter (``clock64``) at the start of each closure round and
after each of its parts, adds the differences up, and counts the grid
barriers each part passes. It builds the copy with ``nvcc``, runs it once
at the 3,000-base cut (2,508 pairs over 3,000 bases, M=100), config-1
(25,000 pairs over 29,903 bases, M=100) and 1M pairs over 30,000 bases
(M=1000), 150 bp reads with uniform starts from seed 12345, padded to
4,096 as ``quasi-mcp-flow-cuda`` pads them, and prints each part's share
of the rounds' cycles and the microseconds that share is of a round (CTA
0's global-timer nanoseconds inside global relabels over the closure
rounds), then one JSON line. Rounds count from the first hop: the closure
before it (pass 0) is reported apart, and the round that stops the
fixpoint is cut at its first barrier and not counted.

The parts. Four-barrier source: barrier 1 with its fold and the forward
scan ("scan 1"), barrier 2 with its fold and the reverse scan ("scan 2"),
snapshot 1 with its barrier and the forward hop, snapshot 2 with its
barrier and the backward hop (with the stop flag's block or). Two-barrier
source: both in-chunk scans and the record ("scans"), the record barrier
with the folds of every chunk's record and the closure ("records"), the
forward hop from the published words, snapshot 2 with its barrier and the
backward hop. Needs a CUDA card; the port's own kernel is untouched (the
copy is a separate library).
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
OUT = ROOT / "build" / "flow_split"
# (pairs, genome, M) of 150 bp reads with uniform starts from seed 12345
CELLS = {"3,000-base cut": (2_508, 3_000, 100), "config-1": (25_000, 29_903, 100),
         "1M pairs over 30 kb": (1_000_000, 30_000, 1000)}
PAD = 4096

# the four-barrier source's C entry: (arcs, off, hopF, rangeF, hopB, rangeB,
# cap_src, cap_snk, excess0, label0, f_read, f_chain, f_src, f_snk, excess,
# label, scalars, ws, n, R, G, max_supersteps, relabel_every, nodes_in_ws,
# stream); its workspace and its node arrays (9 int32 arrays of C a CTA)
PER_READ_SIGNATURE = [ctypes.c_void_p] * 18 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]
_PER_READ_CTRL, _PER_READ_PARTIAL, _PER_READ_NODE_ARRAYS = 16, 8, 4
_PER_READ_KERNEL_ARRAYS, _PER_READ_SMEM_BUDGET = 9, 232_448 - 1_024

_STAMP = ("{{ if (blockIdx.x == 0 && threadIdx.x == 0) {{ const long long t_ = clock64(); "
          "{acc}gd_split_last = t_; gd_split_bars_last = gd_split_bars; }} }}")
_ACC = ("gd_split_acc[{k} + (pass ? 0 : 8)] += t_ - gd_split_last; "
        "gd_split_nbar[{k} + (pass ? 0 : 8)] += gd_split_bars - gd_split_bars_last; ")
# per version: the closure loop's first line, then the line after which
# each part ends, and the parts' names
VERSIONS = {
    "four barriers": (
        r"for \(;;\) \{",
        [r"closure_down\(ch, min\(carry, ex_down\)\);\s*__syncthreads\(\);",
         r"closure_up\(ch, ef, ev\);\s*__syncthreads\(\);",
         r"hop\(ch, cf, cntF, g\.snap1\);\s*__syncthreads\(\);",
         r"my_chg = __syncthreads_or\(lowered\);"],
        ["scan 1", "scan 2", "forward hop", "backward hop"]),
    "two barriers": (
        r"for \(;;\) \{",
        [r"// the record barrier\n",
         r"__syncthreads\(\);\n(?=\s*if \(pass == 0\))",
         r"if \(x < BIG\) atomicMin\(&ch\.d\[e\.x\], x \+ 1\);\s*\}\s*__syncthreads\(\);",
         r"my_chg = __syncthreads_or\(lowered\);"],
        ["scans", "records", "forward hop", "backward hop"]),
}
_HEADER = """
__device__ long long gd_split_acc[16];
__device__ long long gd_split_nbar[16];
__device__ long long gd_split_last;
__device__ long long gd_split_bars;
__device__ long long gd_split_bars_last;
__device__ __forceinline__ void gd_split_grid_sync(unsigned* bar, unsigned& target) {
  if (blockIdx.x == 0 && threadIdx.x == 0) ++gd_split_bars;
  gd::grid_sync(bar, target);
}
extern "C" int gd_split_read(long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, gd_split_acc, sizeof(gd_split_acc));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out + 16, gd_split_nbar, sizeof(gd_split_nbar));
  return (int)e;
}
extern "C" int gd_split_reset() {
  long long z[16] = {0};
  cudaError_t e = cudaMemcpyToSymbol(gd_split_acc, z, sizeof(z));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(gd_split_nbar, z, sizeof(z));
  return (int)e;
}
"""


def entry_args(text: str) -> int:
    """The number of arguments of ``gd_push_relabel_solve`` in a source."""
    decl = re.search(r'extern\s+"C"\s+int\s+gd_push_relabel_solve\s*\(([^)]*)\)', text)
    if decl is None:
        raise ValueError("no gd_push_relabel_solve in the source")
    return decl.group(1).count(",") + 1


def per_read(text: str) -> bool:
    """Whether a source's entry takes one hop-table row a read (the
    four-barrier source) rather than the port's groups."""
    return entry_args(text) == len(PER_READ_SIGNATURE)


def instrument(text: str):
    """(instrumented source, version, part names) of a ``push_relabel.cu``
    text."""
    version = "four barriers" if per_read(text) else "two barriers"
    start, ends, names = VERSIONS[version]
    body = text.index("__device__ int closure")
    m = re.compile(start).search(text, body)
    if m is None:
        raise ValueError(f"no closure loop ({start}) in the {version} source")
    text = text[:m.end()] + _STAMP.format(acc="") + text[m.end():]
    for k, pat in enumerate(ends):
        m = re.compile(pat).search(text, body)
        if m is None:
            raise ValueError(f"no {pat} in the {version} source")
        text = text[:m.end()] + _STAMP.format(acc=_ACC.format(k=k)) + text[m.end():]
    # every grid barrier counted: the calls after the header's include
    at = text.index("namespace {")
    head, rest = text[:at], text[at:]
    rest = re.sub(r"(?<![\w:])grid_sync\(", "gd_split_grid_sync(", rest)
    return head + _HEADER + rest, version, names


def build(source: Path, tag: str) -> ctypes.CDLL:
    from genome_downsampler_tpu_torch.ops import build as kbuild

    OUT.mkdir(parents=True, exist_ok=True)
    text, _, _ = instrument(source.read_text())
    cu = OUT / f"{tag}.cu"
    cu.write_text(text)
    lib = OUT / f"lib{tag}.so"
    csrc = Path(kbuild.__file__).parent / "csrc"
    cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-I", str(csrc), "-shared", "-o", str(lib),
           str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise kbuild.KernelBuildError(f"{' '.join(cmd)}\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def per_read_tables(start, end1, read_valid, n: int, G: int, C: int):
    """The four-barrier source's hop tables: the valid reads sorted (stably)
    by start and by end + 1, int32[R, 4] rows ``(tail, other end, read,
    0)``, each with int32[G + 1] each CTA's share."""
    dev = start.device
    reads = torch.arange(start.shape[0], dtype=torch.int32, device=dev)
    bounds = (torch.arange(G + 1, dtype=torch.int64, device=dev) * C).clamp(
        max=n + 1).to(torch.int32)
    out = []
    for tail, other in ((start, end1), (end1, start)):
        key, order = torch.sort(torch.where(read_valid, tail, n + 1), stable=True)
        rows = torch.stack([tail[order], other[order], reads[order], torch.zeros_like(reads)], 1)
        out += [rows.contiguous(), torch.searchsorted(key, bounds).to(torch.int32)]
    return out


def lib_per_read(lib) -> bool:
    """Whether a bound library's entry is the four-barrier source's."""
    return len(lib.gd_push_relabel_solve.argtypes) == len(PER_READ_SIGNATURE)


def prepare(four_barriers: bool, start, end, read_valid, capped, n: int, sms: int) -> dict:
    """The inputs of a source's entry: the port's ``prepare``, or, for the
    four-barrier source, its per-read tables and workspace."""
    from genome_downsampler_tpu_torch.ops import push_relabel as pr
    from genome_downsampler_tpu_torch.ops.ssp import grid_shape
    from genome_downsampler_tpu_torch.solvers.push_relabel import preflow

    if not four_barriers:
        return pr.prepare(start, end, read_valid, capped, n, sms)
    R = start.shape[0]
    G, C = grid_shape(n, sms)
    arcs, off = pr.kernel_arc_table(start, end, read_valid, n)
    hop_f, range_f, hop_b, range_b = per_read_tables(start, end + 1, read_valid, n, G, C)
    cap_src, cap_snk, st = preflow(capped, n, R)
    words = _PER_READ_KERNEL_ARRAYS * ((C + 3) // 4 * 4)
    in_ws = 4 * words > _PER_READ_SMEM_BUDGET
    head = _PER_READ_CTRL + _PER_READ_PARTIAL * G + _PER_READ_NODE_ARRAYS * (n + 3)
    return {"per_read": True,
            "ins": [arcs, off, hop_f, range_f, hop_b, range_b, cap_src, cap_snk, st.excess,
                    st.label],
            "ws_words": (head + 1) // 2 * 2 + 4 * R + (G * words if in_ws else 0),
            "n": n, "R": R, "G": G, "nodes_in_ws": in_ws}


def launch(lib, prep: dict, max_supersteps: int = 200_000, relabel_every: int = 25):
    """One launch of ``lib``'s entry on ``prepare``'s tensors, uncounted:
    ``ops.push_relabel.launch``'s result, for either version."""
    from genome_downsampler_tpu_torch.ops import build as kbuild
    from genome_downsampler_tpu_torch.ops import push_relabel as pr

    if not prep.get("per_read"):
        return pr.launch(lib, prep, max_supersteps, relabel_every)
    n, R, G = prep["n"], prep["R"], prep["G"]
    dev = prep["ins"][0].device
    i32 = torch.int32
    out = [torch.empty(m, dtype=i32, device=dev) for m in (R, n, n + 1, n + 1, n + 3, n + 3)]
    scalars = torch.empty(10, dtype=torch.int64, device=dev)
    ws = torch.empty(prep["ws_words"], dtype=i32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gd_push_relabel_solve(
            *(x.data_ptr() for x in (*prep["ins"], *out, scalars, ws)),
            n, R, G, int(max_supersteps), int(relabel_every), int(prep["nodes_in_ws"]),
            torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check("gd_push_relabel_solve", rc)
    return (*out, scalars)


def bind(lib, text: str):
    """Set the argument types of ``lib``'s entry as the source declares it."""
    from genome_downsampler_tpu_torch.ops import build as kbuild

    fn = lib.gd_push_relabel_solve
    fn.restype = ctypes.c_int
    fn.argtypes = (PER_READ_SIGNATURE if per_read(text)
                   else kbuild._SIGNATURES["gd_push_relabel_solve"])


def split(lib, names, prep):
    """Run ``lib`` once on ``prep``; the parts' shares, us and barriers a
    round."""
    lib.gd_split_reset()
    *_, scalars = launch(lib, prep)
    torch.cuda.synchronize()
    step, _, relabels, rounds, ns_rl = scalars.tolist()[:5]
    acc = (ctypes.c_longlong * 32)()
    lib.gd_split_read(acc)
    cyc, bars = list(acc)[:16], list(acc)[16:]
    total = sum(cyc[:len(names)])
    us_round = ns_rl / 1e3 / max(rounds, 1)
    return {
        "rounds": rounds, "supersteps": step, "global_relabels": relabels,
        "closure_ms": ns_rl / 1e6, "us_per_round": us_round,
        "barriers_per_round": sum(bars[:len(names)]) / max(rounds, 1),
        "pass0_barriers_per_closure": sum(bars[8:8 + len(names)]) / max(2 * relabels, 1),
        "pass0_cycle_share": sum(cyc[8:8 + len(names)]) / max(total + sum(cyc[8:16]), 1),
        "parts": {k: {"share": c / total, "us_per_round": us_round * c / total,
                      "barriers_per_round": b / max(rounds, 1)}
                  for k, c, b in zip(names, cyc, bars)},
    }


def main(argv=None) -> int:
    from genome_downsampler_tpu_torch.device import gpu_report, require_cuda
    from genome_downsampler_tpu_torch.testing.flow_cases import flow_inputs
    from genome_downsampler_tpu_torch.testing.reads_gen import rand_reads_uniform

    sources = [Path(p) for p in (sys.argv[1:] if argv is None else argv)]
    if not sources:
        print(__doc__, file=sys.stderr)
        return 2
    from genome_downsampler_tpu_torch.ops import build as kbuild

    dev = require_cuda()
    report = gpu_report()
    kbuild.load_kernels()  # ops.build.check reads the port's error strings
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cells = {}
    for cell, (pairs, n, m) in CELLS.items():
        b = rand_reads_uniform(np.random.default_rng(12345), pairs, n, 150)
        cells[cell] = flow_inputs(b, m, PAD, dev)
    result = {"card": report, "sources": {}}
    for i, src in enumerate(sources):
        t0 = time.perf_counter()
        text = src.read_text()
        _, version, names = instrument(text)
        lib = build(src, f"split{i}")
        bind(lib, text)
        lib.gd_split_read.argtypes = [ctypes.c_void_p]
        per = {}
        for cell, args in cells.items():
            prep = prepare(per_read(text), *args, sms)
            per[cell] = r = split(lib, names, prep)
            print(f"{src} ({version}) at {cell}: {r['rounds']} rounds, "
                  f"{r['closure_ms']:.3f} ms in closures, {r['us_per_round']:.3f} us a round, "
                  f"{r['barriers_per_round']:.2f} grid barriers a round: "
                  + ", ".join(f"{k} {v['share']:.1%} ({v['us_per_round']:.3f} us, "
                              f"{v['barriers_per_round']:.2f} barriers)"
                              for k, v in r["parts"].items())
                  + f"; pass 0 {r['pass0_barriers_per_closure']:.2f} barriers a closure, "
                  f"{r['pass0_cycle_share']:.1%} of the closure cycles  [{report}]",
                  flush=True)
            del prep
        result["sources"][str(src)] = {"version": version, "cells": per,
                                       "seconds": time.perf_counter() - t0}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
