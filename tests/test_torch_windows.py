"""The port's windowed sweep (kernel A's twin over W window rows) against
the JAX ``windowed_sweep_counts`` and ``WindowedMcpSolver``, and the host
greedy. Integer bit-equality throughout, rounds included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_downsampler_tpu.ops.coverage import capped_coverage as jax_capped
from genome_downsampler_tpu.ops.coverage import coverage_from_intervals as jax_cov
from genome_downsampler_tpu.parallel import windows as jax_windows
from genome_downsampler_tpu.solvers import device_sweep as jax_ds
from genome_downsampler_tpu.solvers.native_greedy import NativeGreedyMcpSolver
from genome_downsampler_tpu.testing.fixtures import dist_with_hole
from genome_downsampler_tpu.testing.reads_gen import rand_reads, rand_reads_uniform
from genome_downsampler_tpu_torch.parallel.windows import (
    WindowedMcpSolver,
    windowed_sweep_counts,
)

L = 64


@pytest.mark.parametrize(
    "W,seed,m,pairs,rounds_seen",
    # rounds from the JAX loop: stable early (2, 6) and capped at W (2, 4, 8)
    [(2, 0, 8, 2000, 2), (4, 1, 3, 2000, 4), (8, 2, 20, 2000, 8),
     (8, 3, 2, 1000, 6), (8, 3, 30, 1000, 2)],
)
def test_windowed_counts_and_rounds_match_jax(W, seed, m, pairs, rounds_seen):
    n = 4096
    batch = rand_reads_uniform(np.random.default_rng(seed), pairs, n, 60)
    s, e = jnp.asarray(batch.start), jnp.asarray(batch.end)
    w = jnp.ones(batch.n_reads, jnp.int32)
    rows = np.asarray(jax_ds.build_start_rows(s, e - s + 1, w, n, L))
    target = np.asarray(jax_capped(jax_cov(s, e, n, w), m))
    win = n // W
    ref_sel, ref_rounds = jax_windows.windowed_sweep_counts(
        jnp.asarray(rows), jnp.asarray(target), W, win, L
    )
    sel, rounds = windowed_sweep_counts(
        torch.from_numpy(rows.copy()), torch.from_numpy(target.copy()), W, win, L
    )
    np.testing.assert_array_equal(sel.numpy(), np.asarray(ref_sel))
    assert rounds == int(ref_rounds) == rounds_seen


@pytest.mark.parametrize("W", [1, 3, 8])
def test_windowed_solver_matches_greedy_and_jax(W):
    batch = rand_reads_uniform(np.random.default_rng(5), 1500, 4000, 60)
    m = 6
    solver = WindowedMcpSolver("cpu", n_windows=W, max_span=L)
    sel = solver.solve(m, batch)
    np.testing.assert_array_equal(sel, NativeGreedyMcpSolver().solve(m, batch))
    np.testing.assert_array_equal(
        sel, jax_windows.WindowedMcpSolver(n_windows=W, max_span=L).solve(m, batch)
    )
    assert solver.last_stats["n_windows"] == W
    assert 1 <= solver.last_stats["rounds"] <= W


def test_windowed_shaped_distribution_matches_greedy():
    batch = rand_reads(np.random.default_rng(12345), 1500, 3000, 100, dist_with_hole)
    sel = WindowedMcpSolver("cpu", n_windows=4, max_span=128).solve(40, batch)
    np.testing.assert_array_equal(sel, NativeGreedyMcpSolver().solve(40, batch))


def test_window_too_small_raises():
    batch = rand_reads_uniform(np.random.default_rng(1), 100, 1000, 60)
    with pytest.raises(ValueError, match="window length"):
        WindowedMcpSolver("cpu", n_windows=64, max_span=64).solve(5, batch)
    with pytest.raises(ValueError, match="window length"):
        jax_windows.WindowedMcpSolver(n_windows=64, max_span=64).solve(5, batch)
    with pytest.raises(ValueError, match="exceeds max_span"):
        WindowedMcpSolver("cpu", n_windows=2, max_span=32).solve(5, batch)


def test_windowed_solver_requires_an_available_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WindowedMcpSolver("cuda")
