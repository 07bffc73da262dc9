"""Paired Illumina reads of whole-genome shotgun sequencing: fragments
that start uniformly along a linear genome, each read from both ends.

Pair ``i``'s fragment starts uniformly in ``0..genome_length -
max_fragment`` (so every fragment fits, whatever its length) and is
``min_fragment..max_fragment`` bases long, uniformly; the first mate reads
``read_length`` bases from its start, the second the last ``read_length``
bases to its end. ``end`` is inclusive; mates at adjacent indices, first
mate first.
"""

import numpy as np


def layout(rng, genome_length, pairs, read_length, min_fragment, max_fragment):
    """``(start, end)``, int64 arrays of ``2 * pairs`` reads."""
    if not read_length <= min_fragment <= max_fragment <= genome_length:
        raise ValueError("need read_length <= min_fragment <= max_fragment <= genome_length")
    a = rng.integers(0, genome_length - max_fragment + 1, pairs)
    frag = rng.integers(min_fragment, max_fragment + 1, pairs)
    start = np.empty(2 * pairs, np.int64)
    end = np.empty(2 * pairs, np.int64)
    start[0::2] = a
    end[0::2] = a + read_length - 1
    end[1::2] = a + frag - 1
    start[1::2] = end[1::2] - read_length + 1
    return start, end
