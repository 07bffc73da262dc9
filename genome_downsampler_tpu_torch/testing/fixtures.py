"""Deterministic test fixtures.

``small_example_batch`` reproduces the reference's 16-read hand-written toy
fixture (``reference/src/tests/coverage_tester.cpp:72-93``): genome
length 11, 8 pairs, used with max_coverage 4.
"""

from __future__ import annotations

import numpy as np

from genome_downsampler_tpu_torch.core.readbatch import ReadBatch


def small_example_batch() -> ReadBatch:
    # (bam_id, start, end, quality, seq_length, is_first)
    rows = [
        (0, 0, 2, 0, 3, True),
        (1, 6, 9, 0, 4, False),
        (2, 2, 4, 0, 3, True),
        (3, 6, 8, 0, 3, False),
        (4, 1, 3, 0, 3, True),
        (5, 7, 10, 0, 4, False),
        (6, 3, 6, 0, 4, True),
        (7, 9, 10, 0, 2, False),
        (8, 0, 4, 0, 5, True),
        (9, 7, 9, 0, 3, False),
        (10, 4, 6, 0, 3, True),
        (11, 9, 10, 0, 2, False),
        (12, 1, 4, 0, 4, True),
        (13, 6, 8, 0, 3, False),
        (14, 0, 2, 0, 3, True),
        (15, 4, 6, 0, 3, False),
    ]
    return ReadBatch.from_reads(rows, ref_genome_length=11)


SMALL_EXAMPLE_MAX_COVERAGE = 4


def dist_low_coverage_on_both_sides(x: np.ndarray) -> np.ndarray:
    """``x - x^2`` (coverage_tester.cpp:157-160)."""
    return x - x * x


def dist_with_hole(x: np.ndarray) -> np.ndarray:
    """Piecewise density with a central dip (coverage_tester.cpp:162-169)."""
    y = x * x - x + 0.25
    hole = 1000.0 * y * y + 0.2
    return np.where((x > 0.3684) & (x < 0.6316), hole, 0.5)


def dist_zero_coverage_on_both_sides(x: np.ndarray) -> np.ndarray:
    """Downward parabola clipped at zero (coverage_tester.cpp:171-175)."""
    return -10.0 * (x - 0.5) ** 2 + 1.0
