"""Kernel A's plain torch twin (``ops.sweep``) against the JAX Pallas
kernel (interpret mode), the JAX ``lax.scan`` sweep and the take-matrix
sweep; the port's oracles; the torch entry point.

Every comparison is integer bit-equality. Inputs are made from a numpy
seed and handed to both packages as numpy arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import entry as jax_entry
from genome_downsampler_tpu.ops.coverage import capped_coverage as jax_capped
from genome_downsampler_tpu.ops.coverage import coverage_from_intervals as jax_cov
from genome_downsampler_tpu.ops.pallas_sweep import pallas_sweep_counts
from genome_downsampler_tpu.solvers import device_sweep as jax_ds
from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform
from genome_downsampler_tpu_torch.entry import entry
from genome_downsampler_tpu_torch.ops import sweep
from genome_downsampler_tpu_torch.solvers import device_sweep as torch_ds

L = 64


def _problem(seed, pairs, n, read_len, m):
    """(rows[n, L], target[n]) as numpy, built by the JAX package."""
    batch = rand_reads_uniform(np.random.default_rng(seed), pairs, n, read_len)
    s, e = jnp.asarray(batch.start), jnp.asarray(batch.end)
    w = jnp.ones(batch.n_reads, jnp.int32)
    rows = jax_ds.build_start_rows(s, e - s + 1, w, n, L)
    target = jax_capped(jax_cov(s, e, n, w), m)
    return np.asarray(rows), np.asarray(target)


def _carries(seeded, S=1, seed=9):
    if not seeded:
        return np.zeros((S, L), np.int32), np.zeros((S, L), np.int32)
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 3, (S, L)).astype(np.int32),
            rng.integers(0, 2, (S, L)).astype(np.int32))


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.mark.parametrize(
    "seed,m,block,seeded",
    [(0, 3, 512, False), (1, 9, 512, False), (5, 4, 256, True), (2, 6, 256, False),
     (3, 12, 512, True)],
)
def test_twin_matches_pallas_and_scan(seed, m, block, seeded):
    n = 4096 if block == 512 else 2048
    rows, target = _problem(seed, n // 2, n, 60 if block == 512 else 50, m)
    a0, s0 = _carries(seeded)
    pal = pallas_sweep_counts(
        jnp.asarray(rows), jnp.asarray(target), jnp.asarray(a0[0]),
        jnp.asarray(s0[0]), L, block=block, interpret=True,
    )
    scan = jax_ds.sweep_counts(
        jnp.asarray(rows), jnp.asarray(target), jnp.asarray(a0[0]),
        jnp.asarray(s0[0]), L,
    )
    n0 = sweep.dense_sweep_counts.launches
    got = sweep.dense_sweep_counts(_t(rows[None]), _t(target[None]), _t(a0),
                                   _t(s0), L)
    assert sweep.dense_sweep_counts.launches == n0  # CPU tensors: the twin
    for p, s, g in zip(pal, scan, got):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(p))
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(s))


@pytest.mark.parametrize("seed,m", [(0, 3), (4, 7)])
def test_takes_mode_matches_jax_takes(seed, m):
    rows, target = _problem(seed, 1500, 3072, 60, m)
    z = np.zeros((1, L), np.int32)
    ref = np.asarray(jax_ds.sweep_counts_with_takes(
        jnp.asarray(rows), jnp.asarray(target), L
    ))
    takes, a_out, s_out = sweep.dense_sweep_counts(
        _t(rows[None]), _t(target[None]), _t(z), _t(z), L, takes=True
    )
    np.testing.assert_array_equal(takes[0].numpy(), ref)
    # the port's eager oracle, and the carries of the counting mode
    np.testing.assert_array_equal(
        torch_ds.sweep_counts_with_takes(_t(rows), _t(target), L).numpy(), ref
    )
    sel, a2, s2 = sweep.dense_sweep_counts(_t(rows[None]), _t(target[None]),
                                           _t(z), _t(z), L)
    assert torch.equal(a_out, a2) and torch.equal(s_out, s2)
    # sel_per_end[e] = takes summed over the positions j with j + k = e
    ends = np.add.outer(np.arange(rows.shape[0]), np.arange(L))
    per_end = np.bincount(ends.reshape(-1), weights=ref.reshape(-1),
                          minlength=rows.shape[0] + L)
    np.testing.assert_array_equal(sel[0].numpy(), per_end[: rows.shape[0]])


@pytest.mark.parametrize("takes", [False, True])
def test_rows_axis_equals_single_row_calls(takes):
    probs = [_problem(10 + s, 1000, 2048, 50, 3 + s) for s in range(4)]
    rows = np.stack([p[0] for p in probs])
    target = np.stack([p[1] for p in probs])
    a0, s0 = _carries(True, S=4)
    got = sweep.dense_sweep_counts(_t(rows), _t(target), _t(a0), _t(s0), L,
                                   takes=takes)
    for s in range(4):
        one = sweep.dense_sweep_counts(
            _t(rows[s:s + 1]), _t(target[s:s + 1]), _t(a0[s:s + 1]),
            _t(s0[s:s + 1]), L, takes=takes,
        )
        for g, o in zip(got, one):
            assert torch.equal(g[s], o[0])


def test_port_oracle_matches_jax_scan_with_carries():
    rows, target = _problem(6, 800, 1024, 40, 5)
    a0, s0 = _carries(True)
    ref = jax_ds.sweep_counts(jnp.asarray(rows), jnp.asarray(target),
                              jnp.asarray(a0[0]), jnp.asarray(s0[0]), L)
    got = torch_ds.sweep_counts(_t(rows), _t(target), _t(a0[0]), _t(s0[0]), L)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_entry_matches_jax_entry():
    fn, args = entry("cpu")
    rows, target, a0, s0 = args
    assert rows.shape == (1, 1024, 128) and rows.device.type == "cpu"
    jfn, jargs = jax_entry()
    for a, j in zip(args, jargs):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(j))
    for g, r in zip(fn(*args), jfn(*jargs)):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(r))


def test_dense_sweep_rejects_bad_arguments():
    rows = torch.zeros((2, 16, L), dtype=torch.int32)
    t = torch.zeros((2, 16), dtype=torch.int32)
    z = torch.zeros((2, L), dtype=torch.int32)
    with pytest.raises(ValueError, match="max_span"):
        sweep.dense_sweep_counts(rows, t, z, z, 32)
    with pytest.raises(ValueError, match="target"):
        sweep.dense_sweep_counts(rows, t[:1], z, z, L)
    with pytest.raises(ValueError, match="avail0"):
        sweep.dense_sweep_counts(rows, t, z.long(), z, L)
    with pytest.raises(ValueError, match="contiguous"):
        sweep.dense_sweep_counts(rows, torch.zeros((16, 2), dtype=torch.int32).T,
                                 z, z, L)
    with pytest.raises(ValueError, match="rows"):
        sweep.dense_sweep_counts(rows[0], t, z, z, L)
    # a device that is neither CPU nor CUDA: no silent twin
    meta = [x.to("meta") for x in (rows, t, z, z)]
    with pytest.raises(ValueError, match="no dense sweep"):
        sweep.dense_sweep_counts(*meta, L)
