"""Inputs of the push-relabel kernel (``ops/push_relabel.py::flow_solve``)
and its twin: the JAX suite's cases and the cases that put the kernel's CTA
boundaries to work. The CPU tests, the card tests and ``chip_smoke.py``
share them."""

from __future__ import annotations

import numpy as np
import torch

from genome_downsampler_tpu_torch.ops.coverage import capped_coverage, coverage_from_intervals
from genome_downsampler_tpu_torch.testing.fixtures import (
    SMALL_EXAMPLE_MAX_COVERAGE,
    small_example_batch,
)
from genome_downsampler_tpu_torch.testing.long_reads import _batch as long_read_batch
from genome_downsampler_tpu_torch.testing.long_reads import artic_deep_30kb, uniform_long_reads
from genome_downsampler_tpu_torch.testing.reads_gen import rand_reads_uniform

#: tests/test_push_relabel.py's inputs: its small example and the random
#: reads of test_random_small_feasible's seeds 0 and 1
SUITE_CASES = ("small_example", "seed0", "seed1")
#: n + 1 line nodes at 3 * 256 - 1, 3 * 256 and 3 * 256 + 1: a short last
#: CTA, three full ones, four ragged ones (ops/ssp.py: grid_shape)
BOUNDARY_CASES = ("n+1=767", "n+1=768", "n+1=769")
#: a genome whose CTAs keep their node arrays in the kernel's workspace
#: (more than about 840,000 line nodes on 132 SMs)
LARGE_CASE = "n=900000"
#: reads of 1-120 bases over 4,000 bases, 60,000 on the first half and
#: 2,000 on the second: about 6,800 distinct (start, end + 1) arcs a CTA on
#: the first, more than the hop tables' shared memory holds
#: (ops/push_relabel.py: _TAB_CAP_MAX), so those CTAs keep their tables in
#: the workspace, and the others in shared memory
WIDE_TABLES_CASE = "distinct arcs > shared tables"
#: the ARTIC amplicon layout (98 amplicons over 29,903 bases) at 100,000
#: pairs, M=1000: 196 segments of 1,040-1,059 arcs, each primer's first mates
#: and each amplicon end's second mates, which CTAs walk
ARTIC_CASE = "artic 100,000 pairs"
#: 900,000 line nodes (node arrays in the workspace) with three stacks of
#: 1,500 reads at one start each, M=10 (above the 3.3x of the uniform
#: reads, so the stacks' starts hold excess): segments a CTA walks
LARGE_LONG_CASE = "n=900000 with long segments"
#: the superstep caps that stop the loop mid-block, at a global relabel,
#: just after one, and at convergence (relabel_every 25)
CAPS = (1, 2, 3, 24, 25, 26, 51, 200_000)


def flow_case(name: str):
    """``(batch, M, pad_multiple)`` of one of ``SUITE_CASES``,
    ``BOUNDARY_CASES``, ``LARGE_CASE`` or ``WIDE_TABLES_CASE``."""
    if name == "small_example":
        return small_example_batch(), SMALL_EXAMPLE_MAX_COVERAGE, 32
    if name in ("seed0", "seed1"):
        seed = int(name[4:])
        return rand_reads_uniform(np.random.default_rng(seed), 150, 600, 40), (3, 5)[seed], 512
    if name in BOUNDARY_CASES:
        n = int(name.split("=")[1]) - 1
        return rand_reads_uniform(np.random.default_rng(n), 2 * n // 5, n, 60), 6, 256
    if name == LARGE_CASE:
        n = int(name[2:])
        return rand_reads_uniform(np.random.default_rng(n), 20_000, n, 150), 3, 4096
    if name == ARTIC_CASE:
        return artic_deep_30kb(np.random.default_rng(12345), pairs=100_000), 1000, 4096
    if name == LARGE_LONG_CASE:
        n = 900_000
        rng = np.random.default_rng(n)
        bg = rand_reads_uniform(rng, 20_000, n, 150)
        at = np.repeat(np.array([1_000, 450_000, 899_000], np.int64), 1_500)
        start = np.concatenate([np.asarray(bg.start, np.int64), at])
        end = np.concatenate([np.asarray(bg.end, np.int64),
                              at + rng.integers(50, 150, at.shape[0])])
        return long_read_batch(start, end, n), 10, 4096
    if name == WIDE_TABLES_CASE:
        rng = np.random.default_rng(2_000)
        dense, sparse = (uniform_long_reads(rng, 2_000, r, 1, 120) for r in (60_000, 2_000))
        return long_read_batch(np.concatenate([dense.start, sparse.start + 2_000]),
                               np.concatenate([dense.end, sparse.end + 2_000]), 4_000), 40, 4096
    raise ValueError(name)


def segment_case(length: int, m: int):
    """``(batch, M, pad_multiple)`` where line node 1,000 of a 4,000-base
    genome has exactly ``length`` arcs (at least 4): ``length - 4`` reads
    of 50-149 bases start there, beside its two chain arcs and its source
    and sink arcs; 3,000 reads of 40 bases start or end elsewhere. At M
    below ``length`` the node's excess runs out before its segment
    does."""
    if length < 4:
        raise ValueError(f"a node inside the genome has 4 arcs at least; asked {length}")
    n, at = 4_000, 1_000
    rng = np.random.default_rng(length)
    bg = rand_reads_uniform(rng, 3_000, n, 40)
    keep = (np.asarray(bg.start) != at) & (np.asarray(bg.end) + 1 != at)
    k = length - 4
    start = np.concatenate([np.asarray(bg.start, np.int64)[keep], np.full(k, at, np.int64)])
    end = np.concatenate([np.asarray(bg.end, np.int64)[keep], at + 49 + np.arange(k) % 100])
    return long_read_batch(start, end, n), m, 4096


def flow_inputs(batch, m: int, pad: int, device="cpu"):
    """``(start, end, read_valid, capped, n)`` as ``QuasiMcpPushRelabelSolver``
    builds them from a batch at M=m, reads padded to a multiple of
    ``pad``, on ``device``."""
    arrays, valid = batch.padded(pad)
    n = batch.ref_genome_length
    start = torch.tensor(arrays["start"], device=device)
    end = torch.tensor(arrays["end"], device=device)
    vmask = torch.tensor(valid, device=device)
    cov = coverage_from_intervals(start, end, n, vmask.to(torch.int32))
    return start, end, vmask, capped_coverage(cov, m), n
