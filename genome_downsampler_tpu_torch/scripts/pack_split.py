"""Where a config-5 pack spends its device time, kernel by kernel.

    python -m genome_downsampler_tpu_torch.scripts.pack_split [SOURCE.cu ...]

Each SOURCE defines ``gd_device_pack``: a version of ``ops/csrc/
device_pack.cu``, the port's or an earlier one written out with ``git show
<commit>:genome_downsampler_tpu_torch/ops/csrc/device_pack.cu``; with none,
the port's. Each is built with ``nvcc`` into its own library under
``build/pack_split/``. Its outputs are allocated and filled as the first
source needs them (``packed`` -1, ``counts``, ``diff`` and ``fill`` 0; a
later source overwrites them), and one config-5 pack (100M Weyl reads over
250 Mb, W=64, B=128, L=256, cap=128), after a warm one, runs under
``torch.profiler``, which names each kernel's device time. Prints each
kernel's and the fills' device ms and ends with one JSON line. Needs a card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from genome_downsampler_tpu_torch.ops import build as kbuild
from genome_downsampler_tpu_torch.ops import device_pack
from genome_downsampler_tpu_torch.scripts import bench_chr1 as c5

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "pack_split"


def build(source: Path, tag: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{tag}.so"
    cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-shared", "-o", str(lib), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise kbuild.KernelBuildError(f"{' '.join(cmd)}\n{proc.stderr}")
    out = ctypes.CDLL(str(lib))
    out.gd_device_pack.restype = ctypes.c_int
    out.gd_device_pack.argtypes = kbuild._SIGNATURES["gd_device_pack"]
    return out


def pack(lib, dev):
    """One config-5 pack by ``lib`` into freshly filled outputs."""
    win, nbw, n_pad = device_pack.geometry(c5.N, c5.W, c5.B)
    outs = (torch.full((nbw, c5.W, c5.CAP), -1, dtype=torch.int32, device=dev),
            torch.zeros((nbw, c5.W), dtype=torch.int32, device=dev),
            torch.zeros(n_pad + 1, dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))
    kbuild.check("gd_device_pack", lib.gd_device_pack(
        *(t.data_ptr() for t in outs), c5.READS, c5.N, c5.READ_LEN, c5.W, win, c5.B, c5.L,
        c5.CAP, torch.cuda.current_stream(dev).cuda_stream))
    return outs


def split(lib, dev) -> dict:
    """``{kernel name: device ms}`` of one traced pack."""
    from torch.autograd import DeviceType

    pack(lib, dev)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pack(lib, dev)
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return per


def main(argv=None) -> int:
    from genome_downsampler_tpu_torch.device import gpu_report, require_cuda

    args = sys.argv[1:] if argv is None else argv
    dev = require_cuda()
    report = gpu_report()
    sources = [Path(a) for a in args] or [ROOT / "genome_downsampler_tpu_torch" / "ops" /
                                          "csrc" / "device_pack.cu"]
    res = {}
    for i, src in enumerate(sources):
        per = split(build(src, f"pack{i}"), dev)
        res[str(src)] = per
        print(f"{src}: device {sum(per.values()):.4f} ms  [{report}]", flush=True)
        for name, ms in sorted(per.items(), key=lambda kv: -kv[1]):
            print(f"  {ms:.4f} ms  {name[:100]}", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"pack_split": res, "card": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
