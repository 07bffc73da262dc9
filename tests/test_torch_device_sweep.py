"""The port's dense-engine solvers (plain twins on the CPU) against the JAX
``McpDeviceSweepSolver`` / ``QmcpDeviceSweepSolver`` and the host greedy;
the dense/blocked dispatch, the span guard, and the port's copies of
``reconstruct_selection`` and ``quality_aware_assignment``."""

import numpy as np
import pytest
import torch

from genome_downsampler_tpu.core.readbatch import ReadBatch
from genome_downsampler_tpu.solvers import device_sweep as jax_ds
from genome_downsampler_tpu.solvers.native_greedy import NativeGreedyMcpSolver
from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform
from genome_downsampler_tpu_torch import _native
from genome_downsampler_tpu_torch.ops import sweep
from genome_downsampler_tpu_torch.solvers import device_sweep as torch_ds
from genome_downsampler_tpu_torch.solvers.device_sweep import (
    McpDeviceSweepSolver,
    QmcpDeviceSweepSolver,
)


def _batch(start, end, n, quality=None):
    r = len(start)
    return ReadBatch(
        bam_id=np.arange(r, dtype=np.int64),
        start=np.asarray(start, np.int64),
        end=np.asarray(end, np.int64),
        quality=np.full(r, 50, np.int64) if quality is None else quality,
        seq_length=(np.asarray(end) - np.asarray(start) + 1).astype(np.int64),
        is_first=np.tile([True, False], r // 2 + 1)[:r],
        ref_genome_length=n,
    )


@pytest.mark.parametrize("seed,m,span", [(0, 3, 64), (1, 9, 64), (2, 25, 256)])
def test_dense_solver_matches_jax_solver_and_greedy(seed, m, span):
    read_len = 60 if span == 64 else 150
    batch = rand_reads_uniform(np.random.default_rng(seed), 1500, 4096, read_len)
    solver = McpDeviceSweepSolver("cpu", max_span=span)
    sel = solver.solve(m, batch)
    assert solver.last_stats["engine"] == "dense"
    ref = jax_ds.McpDeviceSweepSolver(max_span=span, use_pallas=False).solve(m, batch)
    np.testing.assert_array_equal(sel, ref)
    np.testing.assert_array_equal(sel, NativeGreedyMcpSolver().solve(m, batch))


def test_pick_engine_edge_matches_jax():
    ours = McpDeviceSweepSolver("cpu")
    ref = jax_ds.McpDeviceSweepSolver()
    assert torch_ds.DENSE_ROWS_BUDGET_BYTES == jax_ds.DENSE_ROWS_BUDGET_BYTES
    for n, want in ((30_000, "dense"), (262_144, "dense"), (262_145, "blocked")):
        assert ours._pick_engine(n) == ref._pick_engine(n) == want
    assert McpDeviceSweepSolver("cpu", engine="blocked")._pick_engine(1000) == "blocked"
    with pytest.raises(ValueError, match="unknown engine"):
        McpDeviceSweepSolver("cpu", engine="sparse")


def test_dense_engine_matches_blocked_engine():
    batch = rand_reads_uniform(np.random.default_rng(7), 1500, 4096, 60)
    dense = McpDeviceSweepSolver("cpu", max_span=64, engine="dense")
    blocked = McpDeviceSweepSolver("cpu", max_span=64, engine="blocked")
    sel = dense.solve(7, batch)
    np.testing.assert_array_equal(sel, blocked.solve(7, batch))
    assert blocked.last_stats["engine"] == "blocked"
    assert blocked.last_stats["rounds"] >= 1
    assert list(blocked.last_stats["phases_s"])[0] == "pack"


@pytest.mark.parametrize("n", [8_192, 300_000])
def test_span_guard_raises_before_dispatch(n):
    """A read longer than max_span is refused on both sides of the edge,
    as mcp-tpu refuses it (the blocked engine alone would grow L)."""
    rng = np.random.default_rng(3)
    start = rng.integers(0, n - 400, 50)
    end = start + 99
    end[7] = start[7] + 256  # span 257
    batch = _batch(start, end, n)
    solver = McpDeviceSweepSolver("cpu")
    assert solver._pick_engine(n) == ("dense" if n < 262_145 else "blocked")
    with pytest.raises(ValueError, match="exceeds max_span=256"):
        solver.solve(5, batch)
    with pytest.raises(ValueError, match="exceeds max_span=256"):
        jax_ds.McpDeviceSweepSolver().solve(5, batch)
    with pytest.raises(ValueError, match="exceeds max_span=256"):
        QmcpDeviceSweepSolver("cpu").solve(5, batch)


def test_empty_batch_selects_nothing():
    empty = _batch(np.zeros(0, np.int64), np.zeros(0, np.int64), 1000)
    assert McpDeviceSweepSolver("cpu").solve(3, empty).size == 0
    assert QmcpDeviceSweepSolver("cpu").solve(3, empty).size == 0


def _per_end_counts(seed, r, n, m):
    """(start, end, sel_per_end) of a seeded greedy solve."""
    batch = rand_reads_uniform(np.random.default_rng(seed), r // 2, n, 40)
    start, end = np.asarray(batch.start), np.asarray(batch.end)
    sel = NativeGreedyMcpSolver().solve(m, batch)
    return start, end, np.bincount(end[sel], minlength=n)


@pytest.mark.parametrize("seed,r,n,m", [(0, 3000, 2000, 4), (1, 20_000, 9000, 11)])
def test_reconstruct_selection_matches_jax_numpy_and_native(seed, r, n, m):
    start, end, spe = _per_end_counts(seed, r, n, m)
    ref = jax_ds.reconstruct_selection(start, end, spe)
    np.testing.assert_array_equal(torch_ds.reconstruct_selection(start, end, spe), ref)
    np.testing.assert_array_equal(_native.reconstruct(start, end, spe), ref)
    np.testing.assert_array_equal(jax_ds._reconstruct_native(start, end, spe), ref)
    with pytest.raises(ValueError, match="gd_reconstruct"):
        _native.reconstruct(start, end, spe + 10_000)


def test_reconstruct_selection_dispatches_to_native_at_200k(monkeypatch):
    start, end, spe = _per_end_counts(2, 200_000, 60_000, 5)
    calls = []
    real = _native.reconstruct
    monkeypatch.setattr(_native, "reconstruct",
                        lambda *a: calls.append(1) or real(*a))
    got = torch_ds.reconstruct_selection(start, end, spe)
    assert calls == [1]
    np.testing.assert_array_equal(got, jax_ds.reconstruct_selection(start, end, spe))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quality_aware_assignment_matches_jax(seed):
    rng = np.random.default_rng(seed)
    r, n = 2000, 3000
    start = rng.integers(0, n - 60, r)
    end = start + rng.integers(10, 60, r)
    quality = rng.integers(0, 61, r)
    # seeded takes: per end bucket, up to its size, at positions in its span
    t_e = rng.choice(end, 700)
    t_j = t_e - rng.integers(0, 10, 700)
    args = (start, end, quality, t_j.astype(np.int64), t_e.astype(np.int64))
    got = torch_ds.quality_aware_assignment(*args)
    np.testing.assert_array_equal(got, jax_ds.quality_aware_assignment(*args))
    assert got.size > 0
    empty = np.zeros(0, np.int64)
    assert torch_ds.quality_aware_assignment(start, end, quality, empty, empty).size == 0


@pytest.mark.parametrize("seed,m", [(0, 3), (1, 6), (2, 2)])
def test_qmcp_sweep_solver_matches_jax(seed, m):
    batch = rand_reads_uniform(np.random.default_rng(seed), 1500, 4096, 60)
    n0 = sweep.dense_sweep_counts.launches
    sel = QmcpDeviceSweepSolver("cpu", max_span=64).solve(m, batch)
    assert sweep.dense_sweep_counts.launches == n0
    ref = jax_ds.QmcpDeviceSweepSolver(max_span=64, pad_multiple=1024).solve(m, batch)
    np.testing.assert_array_equal(sel, ref)
    mcp = McpDeviceSweepSolver("cpu", max_span=64).solve(m, batch)
    assert len(sel) == len(mcp)
    q = np.asarray(batch.quality, np.int64)
    assert q[sel].sum() >= q[mcp].sum()


def test_qmcp_sweep_prefers_high_quality_duplicates():
    # 4 identical intervals, two high quality; M=2 must keep the two best
    batch = _batch([0, 0, 0, 0], [9, 9, 9, 9], 10,
                   quality=np.array([5, 50, 7, 60], np.int64))
    sel = QmcpDeviceSweepSolver("cpu", max_span=16).solve(2, batch)
    assert sorted(sel.tolist()) == [1, 3]
    ref = jax_ds.QmcpDeviceSweepSolver(max_span=16, pad_multiple=32).solve(2, batch)
    np.testing.assert_array_equal(sel, ref)


def test_solvers_require_an_explicit_available_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (McpDeviceSweepSolver, QmcpDeviceSweepSolver):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls("cuda")
        with pytest.raises(ValueError, match="unsupported device"):
            cls("meta")
