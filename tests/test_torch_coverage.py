"""The port's coverage ops and sequential sweep oracle against the JAX
package's, on the same seeded inputs (integer bit-equality)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_downsampler_tpu.ops import coverage as jax_cov
from genome_downsampler_tpu.solvers import device_sweep as jax_sweep
from genome_downsampler_tpu_torch.ops import coverage
from genome_downsampler_tpu_torch.solvers import device_sweep


@pytest.mark.parametrize("weighted", [False, True])
def test_coverage_matches_jax(weighted):
    rng = np.random.default_rng(8)
    n = 700
    start = rng.integers(-5, n + 5, 2000).astype(np.int32)  # some off-genome
    end = (start + rng.integers(0, 60, 2000)).astype(np.int32)
    w = rng.integers(0, 2, 2000).astype(np.int32) if weighted else None
    ref = jax_cov.coverage_from_intervals(
        jnp.asarray(start), jnp.asarray(end), n,
        None if w is None else jnp.asarray(w),
    )
    got = coverage.coverage_from_intervals(
        torch.from_numpy(start), torch.from_numpy(end), n,
        None if w is None else torch.from_numpy(w),
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        coverage.capped_coverage(got, 9).numpy(),
        np.asarray(jax_cov.capped_coverage(ref, 9)),
    )
    assert coverage.coverage_is_valid(got, got, 9)
    assert not coverage.coverage_is_valid(got, torch.zeros_like(got), 9)



@pytest.mark.parametrize("n", [1, 11, 700])
def test_demand_from_capped_matches_jax(n):
    capped = np.random.default_rng(n).integers(0, 50, n).astype(np.int32)
    ref = jax_cov.demand_from_capped(jnp.asarray(capped))
    got = coverage.demand_from_capped(torch.from_numpy(capped))
    assert got.dtype == torch.int32 and got.shape == (n + 1,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(got.sum()) == 0

def test_build_start_rows_and_sweep_counts_match_jax():
    rng = np.random.default_rng(12)
    n, L = 600, 32
    start = rng.integers(0, n - L, 900).astype(np.int32)
    span = rng.integers(1, L, 900).astype(np.int32)
    w = np.ones(900, np.int32)
    w[::7] = 0  # padded slots
    rows_ref = jax_sweep.build_start_rows(
        jnp.asarray(start), jnp.asarray(span), jnp.asarray(w), n, L
    )
    rows = device_sweep.build_start_rows(
        torch.from_numpy(start), torch.from_numpy(span), torch.from_numpy(w), n, L
    )
    np.testing.assert_array_equal(rows.numpy(), np.asarray(rows_ref))
    target = rng.integers(0, 6, n).astype(np.int32)
    a0 = rng.integers(0, 3, L).astype(np.int32)  # a window's carry-in
    s0 = rng.integers(0, 2, L).astype(np.int32)
    ref = jax_sweep.sweep_counts(
        rows_ref, jnp.asarray(target), jnp.asarray(a0), jnp.asarray(s0), L
    )
    got = device_sweep.sweep_counts(
        rows, torch.from_numpy(target), torch.from_numpy(a0),
        torch.from_numpy(s0), L,
    )
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
