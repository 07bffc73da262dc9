"""Paired Illumina reads on a tiled amplicon panel: a frozen copy of the
port's ``testing/long_reads.py::amplicon_pairs``, so that the benchmark's
traffic stays the same whatever later changes there.

Pair ``i`` lies on amplicon ``i mod amplicons`` (each gets ``pairs //
amplicons`` or one more); the first mate starts at the amplicon's start
(the primer), the second ends at its end, each ``min_len..max_len`` bases
long. ``end`` is inclusive; mates at adjacent indices, first mate first.
"""

import numpy as np


def layout(rng, genome_length, amplicons, first, stride, amplicon_length, pairs, min_len,
           max_len):
    """``(start, end)``, int64 arrays of ``2 * pairs`` reads."""
    if first + (amplicons - 1) * stride + amplicon_length > genome_length:
        raise ValueError("the amplicons run past the genome")
    a = first + (np.arange(pairs, dtype=np.int64) % amplicons) * stride
    start = np.empty(2 * pairs, np.int64)
    end = np.empty(2 * pairs, np.int64)
    start[0::2] = a
    end[0::2] = a + rng.integers(min_len, max_len + 1, pairs) - 1
    end[1::2] = a + amplicon_length - 1
    start[1::2] = end[1::2] - rng.integers(min_len, max_len + 1, pairs) + 1
    return start, end
