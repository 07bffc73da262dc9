"""Synthetic paired-read generators (test-data layer).

Functional port of the reference generators
(``reference/libs/reads-gen/src/reads_gen.cpp:5-86``): histogram-driven
or uniform paired reads over a linear genome. Semantics preserved:

- pairs occupy adjacent indices ``(2k, 2k+1)``, first mate first;
- start positions drawn from the histogram (or uniform), then
  ``first <= second`` enforced by swap;
- overlap/fit adjustments identical to the reference branch structure;
- qualities uniform integers in ``[0, max_quality]``.

Deviation (documented): the reference uses ``std::mt19937`` +
``std::discrete_distribution``; we use NumPy's Generator, so streams are not
bit-identical for a given seed. All framework tests seed our generator
directly (seed 12345 kept for likeness), and correctness properties are
distribution-independent.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from genome_downsampler_tpu_torch.core.readbatch import ReadBatch

DEFAULT_MAX_QUALITY = 100  # reference reads_gen.hpp default


def _assemble(first, second, read_length, qual_first, qual_second, genome_length):
    pairs = first.shape[0]
    start = np.empty(2 * pairs, np.int64)
    start[0::2] = first
    start[1::2] = second
    quality = np.empty(2 * pairs, np.int64)
    quality[0::2] = qual_first
    quality[1::2] = qual_second
    bam_id = np.arange(2 * pairs, dtype=np.int64)
    end = start + read_length - 1
    is_first = np.zeros(2 * pairs, bool)
    is_first[0::2] = True
    return ReadBatch(
        bam_id=bam_id,
        start=start,
        end=end,
        quality=quality,
        seq_length=np.full(2 * pairs, read_length, np.int64),
        is_first=is_first,
        ref_genome_length=genome_length,
    )


def rand_reads(
    rng: np.random.Generator,
    pairs_count: int,
    genome_length: int,
    read_length: int,
    dist_func: Callable[[np.ndarray], np.ndarray],
    max_quality: int = DEFAULT_MAX_QUALITY,
) -> ReadBatch:
    """Histogram-driven paired reads (reference ``rand_reads``,
    ``reads_gen.cpp:5-53``).

    ``dist_func`` maps x in [0, 1] to an unnormalized density over start
    positions; negatives clamp to zero.
    """
    starts_count = genome_length - read_length + 1
    x = np.arange(starts_count, dtype=np.float64) / (starts_count - 1)
    density = np.maximum(np.asarray(dist_func(x), dtype=np.float64), 0.0)
    density = density / density.sum()

    first = rng.choice(starts_count, size=pairs_count, p=density).astype(np.int64)
    second = rng.choice(starts_count, size=pairs_count, p=density).astype(np.int64)
    lo = np.minimum(first, second)
    hi = np.maximum(first, second)

    # Reference fit adjustments (reads_gen.cpp:38-45): if both starts fall in
    # the tail where two reads can no longer be stacked, pin them; else push
    # the second past the first when overlapping beyond one read length.
    tail = genome_length - 2 * read_length
    both_in_tail = (lo > tail) & (hi > tail)
    lo = np.where(both_in_tail, tail, lo)
    hi = np.where(both_in_tail, genome_length - read_length, hi)
    overlap = ~both_in_tail & (lo + read_length > hi)
    hi = np.where(overlap, lo + read_length, hi)

    q1 = rng.integers(0, max_quality + 1, size=pairs_count)
    q2 = rng.integers(0, max_quality + 1, size=pairs_count)
    return _assemble(lo, hi, read_length, q1, q2, genome_length)


def rand_reads_uniform(
    rng: np.random.Generator,
    pairs_count: int,
    genome_length: int,
    read_length: int,
    max_quality: int = DEFAULT_MAX_QUALITY,
) -> ReadBatch:
    """Uniform paired reads (reference ``rand_reads_uniform``,
    ``reads_gen.cpp:55-86``)."""
    first = rng.integers(0, genome_length - 2 * read_length + 1, size=pairs_count)
    second = rng.integers(0, genome_length - read_length + 1, size=pairs_count)
    lo = np.minimum(first, second)
    hi = np.maximum(first, second)
    hi = np.where(lo + read_length > hi, lo + read_length, hi)
    q1 = rng.integers(0, max_quality + 1, size=pairs_count)
    q2 = rng.integers(0, max_quality + 1, size=pairs_count)
    return _assemble(lo, hi, read_length, q1, q2, genome_length)
