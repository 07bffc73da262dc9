"""The port's ``solve_batch`` (one kernel A launch over all samples; its
twin on the CPU) against the JAX ``solve_batch`` and per-sample solves."""

import numpy as np
import pytest
import torch

from genome_downsampler_tpu.core.readbatch import ReadBatch
from genome_downsampler_tpu.solvers.batched import solve_batch as jax_solve_batch
from genome_downsampler_tpu.solvers.native_greedy import NativeGreedyMcpSolver
from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform
from genome_downsampler_tpu_torch.ops import sweep
from genome_downsampler_tpu_torch.solvers.batched import solve_batch


@pytest.mark.parametrize("m", [3, 6])
def test_batched_matches_jax_and_greedy(m):
    rng = np.random.default_rng(0)
    # genomes of different lengths: each sample is padded to the longest
    batches = [rand_reads_uniform(rng, 400 + 100 * i, 4096 - 512 * i, 60)
               for i in range(4)]
    n0 = sweep.dense_sweep_counts.launches
    got = solve_batch(batches, m, "cpu", max_span=64)
    assert sweep.dense_sweep_counts.launches == n0
    ref = jax_solve_batch(batches, m, max_span=64, pad_multiple=1024)
    assert len(got) == len(ref) == 4
    host = NativeGreedyMcpSolver()
    for b, g, r in zip(batches, got, ref):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, host.solve(m, b))


def test_batched_empty():
    assert solve_batch([], 5, "cpu") == []
    assert jax_solve_batch([], 5) == []


def test_batched_sample_without_reads_and_span_guard():
    rng = np.random.default_rng(1)
    full = rand_reads_uniform(rng, 300, 2000, 60)
    z = np.zeros(0, np.int64)
    empty = ReadBatch(bam_id=z, start=z, end=z, quality=z, seq_length=z,
                      is_first=np.zeros(0, bool), ref_genome_length=2000)
    got = solve_batch([full, empty], 4, "cpu", max_span=64)
    np.testing.assert_array_equal(got[0], NativeGreedyMcpSolver().solve(4, full))
    assert got[1].size == 0
    with pytest.raises(ValueError, match="exceeds max_span"):
        solve_batch([full], 4, "cpu", max_span=32)


def test_batched_requires_an_available_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = rand_reads_uniform(np.random.default_rng(2), 50, 1000, 60)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve_batch([b], 4, "cuda")
