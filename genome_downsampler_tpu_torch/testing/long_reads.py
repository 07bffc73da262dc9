"""Synthetic read sets that take kernel B's wide path: long reads (tiled
amplicons, uniform) and amplicon stacks deeper than its register path's
uint16 arrival counts.

``end`` is inclusive. Six named read sets at their default sizes:

- ``midnight_30kb``: tiled 1,200-bp amplicons of the Midnight scheme on a
  SARS-CoV-2-sized genome (Oxford Nanopore amplicon surveillance): 29
  amplicons at a stride of 1,030 bases over 29,903 bases, 200,000 reads
  whose starts are jittered +-25 bases around their amplicon's start and
  whose lengths are 1,150-1,250, clipped to the genome;
- ``long_5mb``: long reads on a bacterial-sized genome, 250,000 reads with
  uniform starts and lengths uniform in 1,000-3,000 over 5 Mb (about
  100x), reads of up to 3,000 bases (L = 3,072: the wide path's
  shared-memory tier 0);
- ``ont_wgs_5mb``: Oxford Nanopore whole-genome sequencing of a bacterial
  isolate: uniform starts over 5,000,000 bases, lengths log-normal with a
  median of 8,000 bases and sigma 0.8 (read N50 about 15 kb), clipped to
  1,000-100,000, drawn until they sum to 100x (about 45,000 reads); the
  longest reads give L = 100,096, past the wide path's shared-memory tiers
  and kernel C's tile;
- ``hifi_chr20``: PacBio HiFi on a human chromosome: uniform starts over
  64,444,167 bases (GRCh38 chr20's length), lengths uniform in
  15,000-25,000, drawn until they sum to 30x (about 96,700 reads; L =
  25,088);
- ``hiv_nfl_9kb``: PacBio circular-consensus reads of near-full-length
  HIV-1 proviral amplicons (intact-provirus studies): one amplicon from
  base 638 of HXB2's 9,719 bases, 20,000 reads starting within 10 bases
  of it (trimmed primers) and 8,900-9,000 bases long (L = 9,088: the wide
  path's shared-memory tier 1 and kernel C's tile);
- ``artic_deep_30kb``: deep Illumina amplicon sequencing of SARS-CoV-2
  (wastewater surveillance) on the ARTIC layout: 98 amplicons of 400 bases
  at a stride of 300 from base 30, 7,000,000 read pairs spread evenly over
  them, the first mate starting at its amplicon's start (the primer), the
  second ending at its end, each 100-150 bases after trimming. 71,428
  first mates start at each primer site: more than 65,535.

Both whole-genome sets take their genome length and read-length bounds as
arguments, so a test can cut them to a small genome with the same shape.

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


def depth_reads(rng: np.random.Generator, genome_length: int, depth: float,
                lengths) -> ReadBatch:
    """Reads with uniform starts, each inside the genome, whose lengths,
    drawn by ``lengths(rng, k)`` for ``k`` reads at a time, are taken in
    order until they sum to ``depth`` times the genome."""
    need = depth * genome_length
    drawn = np.zeros(0, np.int64)
    k = 1024
    while drawn.sum() < need:
        drawn = np.concatenate([drawn, np.minimum(lengths(rng, k), genome_length)])
        k = 1024 + int((need - drawn.sum()) / drawn.mean())
    length = drawn[:int(np.searchsorted(np.cumsum(drawn), need)) + 1]
    start = (rng.random(len(length)) * (genome_length - length + 1)).astype(np.int64)
    return _batch(start, start + length - 1, genome_length)


def ont_wgs_5mb(rng: np.random.Generator, genome_length: int = 5_000_000,
                min_len: int = 1_000, max_len: int = 100_000,
                depth: float = 100.0) -> ReadBatch:
    """The ``ont-wgs-5mb`` read set (module docstring): log-normal lengths,
    median 8,000 and sigma 0.8, clipped to ``min_len..max_len``."""
    return depth_reads(rng, genome_length, depth, lambda r, k: np.clip(
        np.rint(r.lognormal(np.log(8_000), 0.8, k)).astype(np.int64), min_len, max_len))


def hifi_chr20(rng: np.random.Generator, genome_length: int = 64_444_167,
               min_len: int = 15_000, max_len: int = 25_000,
               depth: float = 30.0) -> ReadBatch:
    """The ``hifi-chr20`` read set (module docstring): lengths uniform in
    ``min_len..max_len``."""
    return depth_reads(rng, genome_length, depth,
                       lambda r, k: r.integers(min_len, max_len + 1, k).astype(np.int64))


def long_span_pass(rng: np.random.Generator, L: int, n_windows: int = 2,
                   block: int = 128, blocks: int = 4, reads: int = 300,
                   hot: int = 0):
    """A small pass of kernels B and C at a long span L, for holding them to
    their twins where a full window of L positions would make the twins
    crawl: ``n_windows`` windows of ``blocks`` blocks, ``reads`` reads with
    uniform starts, half with spans uniform in 1..L-1 (their ends may lie
    past the window and the genome: the carries take them), half ending
    within a window's length, plus ``hot`` more starting at the second
    block's position 5 with spans in 1..L-1. Returns ``(start, end,
    packed, counts, win, xwin)``: the packer's layout and each window's
    reads of earlier windows ending at each window-relative position below
    ``block + L`` (kernel C's ``xwin``)."""
    from genome_downsampler_tpu_torch import _native

    W, B = n_windows, block
    n = W * blocks * B
    start = np.concatenate([rng.integers(0, n, reads), np.full(hot, B + 5)]).astype(np.int64)
    reach = np.full(start.shape[0], L - 1)
    reach[:reads // 2] = min(L - 1, blocks * B)
    end = start + (rng.random(start.shape[0]) * reach).astype(np.int64)
    packed, counts, win, _, _ = _native.pack_blocked(start, end, n, W, B, L, cap_multiple=64)
    xwin = np.zeros((W, B + L), np.int32)
    w_id = start // win
    for w in range(1, W):
        rel = end - w * win
        keep = (w_id < w) & (rel >= 0) & (rel < B + L)
        np.add.at(xwin[w], rel[keep], 1)
    return start, end, packed, counts, win, xwin


def capped_coverage(start: np.ndarray, end: np.ndarray, n: int, m: int) -> np.ndarray:
    """``min(coverage, m)`` at each of the first ``n`` positions (int32); reads
    may end past them."""
    d = np.zeros(n + 1, np.int64)
    np.add.at(d, start[start < n], 1)
    np.add.at(d, np.minimum(end[start < n] + 1, n), -1)
    return np.minimum(np.cumsum(d[:n]), m).astype(np.int32)


def midnight_30kb(rng: np.random.Generator, reads: int = 200_000) -> ReadBatch:
    """The ``midnight-30kb`` read set (module docstring)."""
    return amplicon_reads(rng, 29_903, 29, 1_030, reads, 25, 1_150, 1_250)


def long_5mb(rng: np.random.Generator, reads: int = 250_000) -> ReadBatch:
    """The ``long-5mb`` read set (module docstring)."""
    return uniform_long_reads(rng, 5_000_000, reads, 1_000, 3_000)


def hiv_nfl_9kb(rng: np.random.Generator, reads: int = 20_000) -> ReadBatch:
    """The ``hiv-nfl-9kb`` read set (module docstring)."""
    start = 638 + rng.integers(-10, 11, reads)
    end = start + rng.integers(8_900, 9_001, reads) - 1
    return _batch(start.astype(np.int64), end.astype(np.int64), 9_719)


def artic_deep_30kb(rng: np.random.Generator, pairs: int = 7_000_000) -> ReadBatch:
    """The ``artic-deep-30kb`` read set (module docstring)."""
    return amplicon_pairs(rng, 29_903, 98, 30, 300, 400, pairs, 100, 150)
