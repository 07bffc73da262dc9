"""Command line of the port:

    python -m genome_downsampler_tpu_torch INPUT.bam MAX_COVERAGE
        [-o OUT.bam] [-a ALGO] [-b BED] [-t TSV] [-p FILTERED_OUT]
        [-l MIN_LEN] [-q MIN_MAPQ] [-@ THREADS] [-v]
    python -m genome_downsampler_tpu_torch test [-a ALGO...] [-t TESTER...]

The arguments, the ``test`` subcommand and the flow (read the BAM, solve
contig by contig, add mates, write) are those of the JAX package's CLI,
whose parser and test runner are reused; the solvers come from this
package's registry (``*-cuda`` names). ``--windows N`` (N > 1) runs
``WindowedMcpSolver`` on the card and is accepted only with ``mcp-cuda`` /
``quasi-mcp-cuda``. ``--sharded`` and ``--profile-dir`` are not ported yet
and are refused.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from genome_downsampler_tpu.cli.main import build_parser, build_test_parser, run_test
from genome_downsampler_tpu.config import AmpliconBehaviour, BamApiConfig
from genome_downsampler_tpu.solvers.base import SpanGuard
from genome_downsampler_tpu.utils.logging import get_logger, set_verbosity
from genome_downsampler_tpu_torch.solvers.registry import default_registry

_log = get_logger("torch.cli")


def run_downsample(args, registry) -> int:
    unported = {
        "--sharded": args.sharded,
        "--profile-dir": args.profile_dir is not None,
    }
    for flag, given in unported.items():
        if given:
            _log.error("%s is not yet ported to the CUDA package "
                       "(ROADMAP.md, queue A)", flag)
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

    from genome_downsampler_tpu.io.bam import BamReader

    reader = BamReader(input_path, config)
    batch = reader.get_batch()
    t0 = time.perf_counter()
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
