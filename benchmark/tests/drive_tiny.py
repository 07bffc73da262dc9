"""Drive whole runs of a cell at a tiny size on the CPU, the solvers' plain
twins in place of the card: the harness's look for a card skipped, and
optionally a fault planted under the timed path (``harness/faults.py``).

    python benchmark/tests/drive_tiny.py <workload> <case> [<case> ...]

A case is ``sound`` or a fault's name; the last line of standard output
of each is the run's result. Run in a process of its own, so the run's
check for JAX sees only what the run loaded.

Both test-side parts of a cell are found by name, as the harness finds the
rest:

- ``twins/<solver>.py``: ``make()``, the registry solver's plain twin on
  the CPU (its kernels' torch versions), for every solver a traffic mix
  names;
- ``tiny/<config>.json`` (optional): ``reads`` and ``max_coverage``, the
  configuration's reads at a size the twins finish in seconds; without it
  a configuration runs the ARTIC amplicon shape ``TINY`` at ``TINY_M``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import run  # noqa: E402
from harness import faults, spec  # noqa: E402

TWINS = Path(__file__).resolve().parent / "twins"
TINY_DIR = Path(__file__).resolve().parent / "tiny"
# four ARTIC amplicons over 1,500 bases, 60 pairs each: the shape of the
# clinical samples, small enough for the twins
TINY = {"generator": "amplicon_pairs", "genome_length": 1500, "amplicons": 4, "first": 30,
        "stride": 300, "amplicon_length": 400, "pairs": 240, "min_len": 100, "max_len": 150,
        "max_quality": 100}
TINY_M = 20


def tiny_cell(workload: str, tiny_dir: Path = TINY_DIR):
    """The cell with its configuration's tiny reads: ``tiny/<config>.json``
    where there is one, else ``TINY`` at ``TINY_M``."""
    cell = spec.Cell(workload)
    path = tiny_dir / f"{cell.workload['config']}.json"
    tiny = json.loads(path.read_text()) if path.exists() else {
        "reads": TINY, "max_coverage": TINY_M}
    cell.config = {**cell.config, "reads": tiny["reads"], "max_coverage": tiny["max_coverage"]}
    return cell


def twin(name: str):
    """The registry solver ``name``'s plain twin (``twins/<name>.py``), under
    the ``SpanGuard`` the registry puts around every solver."""
    from genome_downsampler_tpu_torch.solvers.base import SpanGuard

    return SpanGuard(spec._module("tests/twins", name).make())


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
