"""Drive whole runs of a cell at a tiny size on the CPU, the solvers' plain
twins in place of the card: the harness's look for a card skipped, and
optionally a fault planted under the timed path (``harness/faults.py``).

    python benchmark/tests/drive_tiny.py <workload> <case> [<case> ...]

A case is ``sound`` or a fault's name; the last line of standard output
of each is the run's result. Run in a process of its own, so the run's
check for JAX sees only what the run loaded.
"""

import argparse
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import run  # noqa: E402
from harness import faults, spec  # noqa: E402

# four ARTIC amplicons over 1,500 bases, 60 pairs each: the shape of the
# clinical samples, small enough for the twins
TINY = {"generator": "amplicon_pairs", "genome_length": 1500, "amplicons": 4, "first": 30,
        "stride": 300, "amplicon_length": 400, "pairs": 240, "min_len": 100, "max_len": 150,
        "max_quality": 100}
TINY_M = 20


def tiny_cell(workload: str):
    cell = spec.Cell(workload)
    cell.config = {**cell.config, "reads": TINY, "max_coverage": TINY_M}
    return cell


def twin(name: str):
    from genome_downsampler_tpu_torch.solvers.base import SpanGuard
    from genome_downsampler_tpu_torch.solvers.device_mcmf import QmcpDeviceMcmfSolver
    from genome_downsampler_tpu_torch.solvers.push_relabel import QuasiMcpPushRelabelSolver

    makers = {"quasi-mcp-flow-cuda": lambda: QuasiMcpPushRelabelSolver("cpu"),
              "qmcp-cuda": lambda: QmcpDeviceMcmfSolver("cpu")}
    return SpanGuard(makers[name]())


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    cell = tiny_cell(args[0])
    for case in args[1:]:
        make = twin if case == "sound" else (lambda n, f=case: faults.Faulty(twin(n), f))
        ns = argparse.Namespace(seed=2**31 + 17, seconds=0.01, trace=0)
        rc = run.run_cell(cell, ns, make, cuda=False, t_start=time.perf_counter())
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
