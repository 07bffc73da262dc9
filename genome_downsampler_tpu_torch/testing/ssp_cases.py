"""Inputs of the SSP kernel (``ops/ssp.py::ssp_solve``) from reads: the
network ``qmcp-cuda`` builds, and the cases that put the kernel's CTA
boundaries to work. The card tests and ``chip_smoke.py`` share them."""

from __future__ import annotations

import numpy as np
import torch

from genome_downsampler_tpu_torch.solvers.device_mcmf import (
    _node_excess,
    _run_tables,
    build_convex_buckets,
)
from genome_downsampler_tpu_torch.testing.reads_gen import rand_reads_uniform

#: the cases of ``boundary_case``
BOUNDARY_CASES = ("ragged chunks", "small chunks", "long spans", "stacked amplicons")


def ssp_network(start, end, cost, n: int, m: int):
    """The SSP kernel's int32 inputs (CPU tensors) for reads (start, end,
    cost) at M=m, as ``ssp_device_flows`` builds them, and the supply."""
    bs, be, off, pool, _, first = build_convex_buckets(start, end, cost)
    B = bs.shape[0]
    excess = _node_excess(bs, be, np.diff(off), n, m)
    lo, hi = _run_tables(pool, first)
    arrays = [bs, be + 1, off[:B], np.diff(off), pool, lo, hi, excess]
    return ([torch.tensor(np.ascontiguousarray(a, np.int32)) for a in arrays],
            int(excess[excess > 0].sum()))


def quality_cost(quality) -> np.ndarray:
    """QMCP's per-read cost, ``max_q - q + 1``."""
    q = np.asarray(quality, np.int64)
    return q.max() - q + 1


def boundary_case(name: str):
    """(start, end, cost, n, M) of one of ``BOUNDARY_CASES``. On 132 SMs:
    "ragged chunks" n + 1 = 3,101 nodes over 13 CTAs of 239 (not a
    multiple); "small chunks" 1,001 over 4 CTAs of 251; "long spans" spans
    up to 1,000 over 10,000 bases, so a source lies two or more CTAs (of
    251 nodes) from its destination; "stacked amplicons" 49 (start, end)
    pairs, 150-300 reads deep each, 40 of them ending in [4,100, 4,200), so
    one CTA owns their forward side."""
    rng = np.random.default_rng(7)
    if name in ("ragged chunks", "small chunks"):
        n = 3_100 if name == "ragged chunks" else 1_000
        b = rand_reads_uniform(np.random.default_rng(12345), int(0.836 * n), n, 150)
        return (np.asarray(b.start, np.int64), np.asarray(b.end, np.int64),
                quality_cost(b.quality), n, 100)
    if name == "long spans":
        n, r = 10_000, 1_200
        start = rng.integers(0, n - 1_000, r)
        end = start + rng.integers(1, 1_000, r)
        return start, end, rng.integers(1, 40, r), n, 30
    if name != "stacked amplicons":
        raise ValueError(f"no SSP case {name!r}; one of {BOUNDARY_CASES}")
    n = 5_000
    pairs = [(int(s), int(rng.integers(4_100, 4_200))) for s in rng.integers(0, 4_000, 40)]
    # a tiling that keeps every base covered
    pairs += [(600 * k, min(600 * k + 700, n - 1)) for k in range(9)]
    depth = rng.integers(150, 300, len(pairs))
    start = np.repeat([p[0] for p in pairs], depth)
    end = np.repeat([p[1] for p in pairs], depth)
    return start, end, rng.integers(1, 8, start.shape[0]), n, 100
