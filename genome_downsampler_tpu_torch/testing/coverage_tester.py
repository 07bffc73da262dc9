"""Coverage tester: the reference's property-based integration tests.

Parity: ``test::CoverageTester``
(``reference/src/tests/coverage_tester.cpp``): five in-memory fixtures
per solver, the validity property ``min(input_cov, M) <= output_cov``
elementwise (``:101-107``), optional ``<test>.cov`` TSV dumps
(``:54-70``). Fixture sizes are the reference's (1M pairs) — use
``scale`` < 1.0 for quick runs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from genome_downsampler_tpu_torch.core.readbatch import ReadBatch
from genome_downsampler_tpu_torch.solvers.base import Solver
from genome_downsampler_tpu_torch.testing.fixtures import (
    dist_low_coverage_on_both_sides,
    dist_with_hole,
    dist_zero_coverage_on_both_sides,
    small_example_batch,
)
from genome_downsampler_tpu_torch.testing.reads_gen import rand_reads, rand_reads_uniform
from genome_downsampler_tpu_torch.utils.logging import get_logger
from genome_downsampler_tpu_torch.utils.timer import ScopedTimer

_log = get_logger("testing.coverage")

CoverageTestResult = Tuple[np.ndarray, np.ndarray]  # (input_cov, output_cov)

SEED = 12345
PAIRS_COUNT = 1_000_000
GENOME_LENGTH = 30_000
READ_LENGTH = 150


def _coverage(batch: ReadBatch, sel: Optional[np.ndarray] = None) -> np.ndarray:
    n = batch.ref_genome_length
    cov = np.zeros(n + 1, np.int64)
    s = batch.start if sel is None else batch.start[sel]
    e = batch.end if sel is None else batch.end[sel]
    np.add.at(cov, np.clip(s, 0, n), 1)
    np.add.at(cov, np.clip(e + 1, 0, n), -1)
    return np.cumsum(cov)[:n].astype(np.uint32)


def is_out_cover_valid(in_cover, out_cover, m: int) -> bool:
    """coverage_tester.cpp:101-107."""
    return bool(np.all(np.minimum(in_cover, m) <= out_cover))


def _run(batch: ReadBatch, m: int, solver: Solver) -> CoverageTestResult:
    input_cover = _coverage(batch)
    sel = solver.solve(m, batch)
    output_cover = _coverage(batch, np.asarray(sel, np.int64))
    assert is_out_cover_valid(input_cover, output_cover, m), (
        "coverage validity violated"
    )
    return input_cover, output_cover


class CoverageTester:
    """Runs the five reference fixtures against a solver."""

    def __init__(self, scale: float = 1.0):
        self.scale = scale

    def _pairs(self) -> int:
        return max(1, int(PAIRS_COUNT * self.scale))

    def small_example_test(self, solver: Solver) -> CoverageTestResult:
        return _run(small_example_batch(), 4, solver)

    def random_uniform_dist_test(self, solver: Solver) -> CoverageTestResult:
        rng = np.random.default_rng(SEED)
        batch = rand_reads_uniform(rng, self._pairs(), GENOME_LENGTH, READ_LENGTH)
        return _run(batch, 1000, solver)

    def _func_dist_test(self, dist: Callable, solver: Solver) -> CoverageTestResult:
        rng = np.random.default_rng(SEED)
        batch = rand_reads(rng, self._pairs(), GENOME_LENGTH, READ_LENGTH, dist)
        return _run(batch, 8000, solver)

    def random_low_coverage_on_both_sides_test(self, solver):
        return self._func_dist_test(dist_low_coverage_on_both_sides, solver)

    def random_with_hole_test(self, solver):
        return self._func_dist_test(dist_with_hole, solver)

    def random_zero_coverage_on_both_sides_test(self, solver):
        return self._func_dist_test(dist_zero_coverage_on_both_sides, solver)

    def tests(self) -> Dict[str, Callable[[Solver], CoverageTestResult]]:
        return {
            "small_example_test": self.small_example_test,
            "random_uniform_dist_test": self.random_uniform_dist_test,
            "random_low_coverage_on_both_sides_test":
                self.random_low_coverage_on_both_sides_test,
            "random_with_hole_test": self.random_with_hole_test,
            "random_zero_coverage_on_both_sides_test":
                self.random_zero_coverage_on_both_sides_test,
        }

    def test(self, solver: Solver, outputs_dir: Optional[Path] = None) -> None:
        for name, fn in self.tests().items():
            _log.info("Running %s...", name)
            with ScopedTimer():
                result = fn(solver)
            if outputs_dir is not None:
                write_covers(result, Path(outputs_dir) / f"{name}.cov")
            _log.info("PASSED!")


def write_covers(result: CoverageTestResult, output_path: Path) -> None:
    """``index \\t input_cov \\t output_cov`` per base (coverage_tester.cpp:54-70)."""
    in_cov, out_cov = result
    with open(output_path, "w") as f:
        for i, (a, b) in enumerate(zip(in_cov, out_cov)):
            f.write(f"{i}\t{a}\t{b}\n")


TESTER_NAMES = ["coverage"]


def get_tester(name: str, scale: float = 1.0) -> CoverageTester:
    if name != "coverage":
        raise KeyError(f"unknown tester: {name}")
    return CoverageTester(scale=scale)
