"""Rows at the edges of the sweep variants' chunks (``ops/variants.py``).

The CUDA variants sweep a row in chunks of ``chunk_positions(L)``
positions, and variant B in groups of ``L / 32`` positions within a chunk.
``edge_lengths(L)`` are the row lengths at those edges, ``variant_case``
seeded rows of every span ``1..L`` for them, optionally with a deep stack
of reads starting at one position. The CPU tests hold the twins against
the JAX package's Pallas variants on these rows, the card tests the
kernels against the twins and kernel A on the same rows.
"""

from __future__ import annotations

import numpy as np

from genome_downsampler_tpu_torch.ops.variants import chunk_positions


def edge_lengths(L: int) -> dict[str, int]:
    """Row lengths at ring width ``L``, by name: one position, one chunk
    less one, one chunk, one more, two chunks and one, and a ragged tail
    (three chunks and part of a group of ``L / 32`` positions at L >= 64)."""
    p = chunk_positions(L)
    return {"1": 1, "P-1": p - 1, "P": p, "P+1": p + 1, "2P+1": 2 * p + 1,
            "ragged": 3 * p + max(L // 64, 1) + 2}


def variant_case(n: int, L: int, m: int, seed: int, stack: int = 0):
    """``(rows[n, L], target[n])`` int32 numpy arrays: ``2 n`` reads (at
    least 8) with uniform starts in ``[0, n)`` and spans in ``[1, L]``, plus
    ``stack`` reads starting at position ``min(3, n - 1)``; ``target`` is
    the coverage within ``[0, n)`` capped at ``m``."""
    rng = np.random.default_rng(seed)
    r = max(2 * n, 8)
    start = rng.integers(0, n, r)
    span = rng.integers(1, L + 1, r)
    if stack:
        start = np.concatenate([start, np.full(stack, min(3, n - 1))])
        span = np.concatenate([span, rng.integers(1, L + 1, stack)])
    rows = np.zeros((n, L), np.int32)
    np.add.at(rows, (start, span - 1), 1)
    delta = np.zeros(n + 1, np.int64)
    np.add.at(delta, start, 1)
    np.add.at(delta, np.minimum(start + span, n), -1)
    target = np.minimum(np.cumsum(delta)[:n], m).astype(np.int32)
    return rows, target
