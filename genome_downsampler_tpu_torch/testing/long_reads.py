"""Synthetic read sets that take kernel B's wide path: long reads (tiled
amplicons, uniform) and amplicon stacks deeper than its register path's
uint16 arrival counts.

``end`` is inclusive. Three named read sets at their default sizes:

- ``midnight_30kb``: tiled 1,200-bp amplicons of the Midnight scheme on a
  SARS-CoV-2-sized genome (Oxford Nanopore amplicon surveillance): 29
  amplicons at a stride of 1,030 bases over 29,903 bases, 200,000 reads
  whose starts are jittered +-25 bases around their amplicon's start and
  whose lengths are 1,150-1,250, clipped to the genome;
- ``long_5mb``: long reads on a bacterial-sized genome, 250,000 reads with
  uniform starts and lengths uniform in 1,000-3,000 over 5 Mb (about
  100x), under the blocked engine's 4,094-base span limit;
- ``artic_deep_30kb``: deep Illumina amplicon sequencing of SARS-CoV-2
  (wastewater surveillance) on the ARTIC layout: 98 amplicons of 400 bases
  at a stride of 300 from base 30, 7,000,000 read pairs spread evenly over
  them, the first mate starting at its amplicon's start (the primer), the
  second ending at its end, each 100-150 bases after trimming. 71,428
  first mates start at each primer site: more than 65,535.

The long-read sets are single-end reads (each its own first mate), as
long-read runs give them; the amplicon pairs lie at adjacent indices,
first mate first. All are drawn from one ``numpy`` generator the caller seeds.
"""

from __future__ import annotations

import numpy as np

from genome_downsampler_tpu_torch.core.readbatch import ReadBatch


def _batch(start: np.ndarray, end: np.ndarray, genome_length: int,
           is_first: np.ndarray | None = None) -> ReadBatch:
    r = start.shape[0]
    return ReadBatch(
        bam_id=np.arange(r, dtype=np.int64),
        start=start,
        end=end,
        quality=np.full(r, 60, np.int32),
        seq_length=(end - start + 1).astype(np.int32),
        is_first=np.ones(r, bool) if is_first is None else is_first,
        ref_genome_length=genome_length,
    )


def amplicon_reads(rng: np.random.Generator, genome_length: int, amplicons: int,
                   stride: int, reads: int, jitter: int, min_len: int,
                   max_len: int) -> ReadBatch:
    """``reads`` reads spread evenly over ``amplicons`` amplicons starting
    every ``stride`` bases; a read starts within ``jitter`` bases of its
    amplicon's start and is ``min_len..max_len`` bases long, clipped to the
    genome."""
    amp = rng.integers(0, amplicons, reads)
    start = np.clip(amp * stride + rng.integers(-jitter, jitter + 1, reads),
                    0, genome_length - 1)
    end = np.minimum(start + rng.integers(min_len, max_len + 1, reads) - 1,
                     genome_length - 1)
    return _batch(start.astype(np.int64), end.astype(np.int64), genome_length)


def amplicon_pairs(rng: np.random.Generator, genome_length: int, amplicons: int,
                   first: int, stride: int, amplicon_length: int, pairs: int,
                   min_len: int, max_len: int) -> ReadBatch:
    """``pairs`` read pairs over ``amplicons`` amplicons of ``amplicon_length``
    bases starting every ``stride`` bases from ``first``, pair ``i`` on
    amplicon ``i mod amplicons`` (so each gets ``pairs // amplicons`` or one
    more): the first mate starts at its amplicon's start, the second ends at
    its end, each ``min_len..max_len`` bases long."""
    if first + (amplicons - 1) * stride + amplicon_length > genome_length:
        raise ValueError("the amplicons run past the genome")
    a = first + (np.arange(pairs, dtype=np.int64) % amplicons) * stride
    start = np.empty(2 * pairs, np.int64)
    end = np.empty(2 * pairs, np.int64)
    start[0::2] = a
    end[0::2] = a + rng.integers(min_len, max_len + 1, pairs) - 1
    end[1::2] = a + amplicon_length - 1
    start[1::2] = end[1::2] - rng.integers(min_len, max_len + 1, pairs) + 1
    is_first = np.zeros(2 * pairs, bool)
    is_first[0::2] = True
    return _batch(start, end, genome_length, is_first)


def uniform_long_reads(rng: np.random.Generator, genome_length: int, reads: int,
                       min_len: int, max_len: int) -> ReadBatch:
    """``reads`` reads of ``min_len..max_len`` bases with uniform starts, each
    inside the genome."""
    length = rng.integers(min_len, max_len + 1, reads)
    start = (rng.random(reads) * (genome_length - length + 1)).astype(np.int64)
    return _batch(start, start + length - 1, genome_length)


def midnight_30kb(rng: np.random.Generator, reads: int = 200_000) -> ReadBatch:
    """The ``midnight-30kb`` read set (module docstring)."""
    return amplicon_reads(rng, 29_903, 29, 1_030, reads, 25, 1_150, 1_250)


def long_5mb(rng: np.random.Generator, reads: int = 250_000) -> ReadBatch:
    """The ``long-5mb`` read set (module docstring)."""
    return uniform_long_reads(rng, 5_000_000, reads, 1_000, 3_000)


def artic_deep_30kb(rng: np.random.Generator, pairs: int = 7_000_000) -> ReadBatch:
    """The ``artic-deep-30kb`` read set (module docstring)."""
    return amplicon_pairs(rng, 29_903, 98, 30, 300, 400, pairs, 100, 150)
