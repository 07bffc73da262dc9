"""Command line of the port:

    python -m genome_downsampler_tpu_torch INPUT.bam MAX_COVERAGE
        [-o OUT.bam] [-a ALGO] [-b BED] [-t TSV] [-p FILTERED_OUT]
        [-l MIN_LEN] [-q MIN_MAPQ] [-@ THREADS] [-v]
    python -m genome_downsampler_tpu_torch test [-a ALGO...] [-t TESTER...]

The arguments, the ``test`` subcommand and the flow (read the BAM, solve
contig by contig, add mates, write) are those of the JAX package's CLI,
whose parser and test runner are copied here; the solvers come from this
package's registry (``*-cuda`` names). ``--windows N`` (N > 1) runs
``WindowedMcpSolver`` on the card and is accepted only with ``mcp-cuda`` /
``quasi-mcp-cuda``. ``--profile-dir DIR`` writes a ``torch.profiler``
trace of the solve to ``DIR/trace.json`` (``utils.profiling``).
``--sharded`` is not ported yet and is refused.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from genome_downsampler_tpu_torch.config import AmpliconBehaviour, BamApiConfig
from genome_downsampler_tpu_torch.solvers.base import SpanGuard
from genome_downsampler_tpu_torch.solvers.registry import (
    DEFAULT_SOLVER_NAME,
    default_registry,
)
from genome_downsampler_tpu_torch.utils.logging import get_logger, set_verbosity

_log = get_logger("cli")


def build_parser(registry) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="genome-downsampler",
        description="GPU genomic read downsampling to a maximum per-base "
        "coverage.",
    )
    p.add_argument("input", nargs="?", metavar="INPUT_FILEPATH",
                   help=".bam input file path. Required option.")
    p.add_argument("max_coverage", nargs="?", type=int, metavar="MAX_COVERAGE",
                   help="Maximum coverage per reference genome's base pair index.")
    p.add_argument("-o", "--output", type=Path,
                   help='.bam output file path. Default is "output.bam" in '
                        "input's directory.")
    p.add_argument("-a", "--algorithm", default=DEFAULT_SOLVER_NAME,
                   choices=registry.get_names(),
                   help=f'Algorithm to use. Default is "{DEFAULT_SOLVER_NAME}"')
    p.add_argument("-b", "--bed", type=Path,
                   help=".bed amplicon bounds specification.")
    p.add_argument("-t", "--tsv", type=Path,
                   help=".tsv pairing of .bed amplicon primers.")
    p.add_argument("-p", "--preprocessing-out", type=Path,
                   help=".bam output for reads filtered out during "
                        "preprocessing (debugging).")
    p.add_argument("-l", "--min-length", type=int, default=90,
                   help="Minimal sequence length. Default is 90.")
    p.add_argument("-q", "--min-mapq", type=int, default=30,
                   help="Minimal MAPQ value. Default is 30.")
    p.add_argument("-@", "--threads", type=int, default=2, dest="threads",
                   help="Thread count for BAM read/write.")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Execute with additional logging.")
    p.add_argument("--profile-dir", type=Path, default=None,
                   help="Write a torch.profiler trace of the solve into this "
                        "directory (trace.json, Chrome trace format).")
    p.add_argument("--windows", type=int, default=1,
                   help="Shard the genome into this many coordinate windows "
                        "solved in parallel on the card (mcp-cuda/"
                        "quasi-mcp-cuda only; the result stays bit-identical "
                        "to one window).")
    p.add_argument("--sharded", action="store_true",
                   help="Host-sharded multi-process pipeline (not ported "
                        "yet; refused).")
    p.add_argument("--halo", type=int, default=2000,
                   help="Sharded-mode window overlap (with --sharded).")
    return p


def build_test_parser(registry) -> argparse.ArgumentParser:
    t = argparse.ArgumentParser(
        prog="genome-downsampler test",
        description="Run solver correctness tests.",
    )
    t.add_argument("-a", "--algorithms", nargs="*", default=[],
                   choices=registry.get_names(),
                   help="Algorithms to test (default: all).")
    t.add_argument("-t", "--tests", nargs="*", default=[],
                   help="Testers to run (default: all).")
    t.add_argument("-o", "--outputs-dir", type=Path,
                   help="Directory for per-test .cov outputs.")
    t.add_argument("--scale", type=float, default=1.0,
                   help="Fixture size multiplier (1.0 = reference-size, 1M pairs).")
    t.add_argument("-v", "--verbose", action="store_true")
    return t


def run_test(args, registry) -> int:
    from genome_downsampler_tpu_torch.testing.coverage_tester import (
        TESTER_NAMES,
        get_tester,
    )

    solvers = args.algorithms or registry.get_names()
    testers = args.tests or TESTER_NAMES
    outputs_dir = args.outputs_dir
    if outputs_dir and not outputs_dir.exists():
        _log.error("Directory: %s does not exist!", outputs_dir)
        return 1
    for tester_name in testers:
        tester = get_tester(tester_name, scale=args.scale)
        _log.info("Running test %s", tester_name)
        for solver_name in solvers:
            _log.info("\ton algorithm %s", solver_name)
            out = None
            if outputs_dir:
                out = outputs_dir / tester_name / solver_name
                out.mkdir(parents=True, exist_ok=True)
            tester.test(registry.get(solver_name), out)
            _log.info("\t\t PASSED")
    return 0


def run_downsample(args, registry) -> int:
    if args.sharded:
        _log.error("%s is not yet ported to the CUDA package "
                   "(ROADMAP.md, queue A)", "--sharded")
        return 2
    if not args.input or not args.max_coverage:
        _log.error("INPUT_FILEPATH and MAX_COVERAGE must be specified")
        return 1
    if args.max_coverage <= 0:
        _log.error("MAX_COVERAGE must be an integer bigger than 0")
        return 1
    input_path = Path(args.input)
    if not input_path.exists():
        _log.error("Input file does not exist: %s", input_path)
        return 1
    output_path = args.output or input_path.parent / "output.bam"

    behaviour = AmpliconBehaviour.IGNORE
    if args.bed:
        behaviour = (
            AmpliconBehaviour.GRADE
            if registry.uses_quality_of_reads(args.algorithm)
            else AmpliconBehaviour.FILTER
        )
    config = BamApiConfig(
        min_seq_length=args.min_length,
        min_mapq=args.min_mapq,
        hts_thread_count=args.threads,
        amplicon_behaviour=behaviour,
        bed_path=args.bed,
        tsv_path=args.tsv,
    )
    # built before the input is read: a *-cuda name without a card raises
    if args.windows > 1:
        if args.algorithm not in ("mcp-cuda", "quasi-mcp-cuda"):
            _log.error(
                "--windows is only supported with mcp-cuda/quasi-mcp-cuda; "
                "algorithm %r would silently ignore it", args.algorithm)
            return 1
        from genome_downsampler_tpu_torch.parallel.windows import (
            WindowedMcpSolver,
        )

        solver = SpanGuard(WindowedMcpSolver("cuda", n_windows=args.windows))
    else:
        solver = registry.get(args.algorithm)

    from genome_downsampler_tpu_torch.io.bam import BamReader
    from genome_downsampler_tpu_torch.utils.profiling import trace

    reader = BamReader(input_path, config)
    batch = reader.get_batch()
    t0 = time.perf_counter()
    with trace(args.profile_dir):
        groups = batch.split_by_contig()
        if len(groups) > 1:
            _log.info("input has %d contigs with reads; solving per contig",
                      len(groups))
        parts = [
            idx[np.asarray(solver.solve(args.max_coverage, sub), np.int64)]
            for _, sub, idx in groups
        ]
    solution = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    _log.debug("solve took %.6f seconds", time.perf_counter() - t0)

    paired = batch.find_pairs(solution)
    _log.info("Writing solution of size %d reads to %s...",
              len(paired), output_path.name)
    reader.write_paired_reads(output_path, paired)
    if args.preprocessing_out:
        _log.info("Writing %d preprocessing filtered out reads to %s...",
                  len(reader.filtered_out), args.preprocessing_out)
        reader.write_filtered_out_reads(args.preprocessing_out)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    registry = default_registry()
    if argv[:1] == ["test"]:
        args = build_test_parser(registry).parse_args(argv[1:])
        set_verbosity(args.verbose)
        return run_test(args, registry)
    args = build_parser(registry).parse_args(argv)
    set_verbosity(args.verbose)
    return run_downsample(args, registry)


if __name__ == "__main__":
    sys.exit(main())
