"""Kernel B's plain torch twin and the port's relaxation loop against the
JAX Pallas kernel (interpret mode) and the sequential sweep oracle.

Every comparison is integer bit-equality. Inputs are made from a numpy
seed and handed to both packages as numpy arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_downsampler_tpu.ops import pallas_blocked as jax_blocked
from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform
from genome_downsampler_tpu_torch import _native
from genome_downsampler_tpu_torch.ops import blocked
from genome_downsampler_tpu_torch.ops.coverage import (
    capped_coverage,
    coverage_from_intervals,
)
from genome_downsampler_tpu_torch.solvers.device_sweep import (
    build_start_rows,
    sweep_counts,
)

W, B, L, CHUNK = 4, 64, 64, 64


def _pack(start, end, n, W, B, L, chunk):
    """Padded codes from the shared C packer, copied out of its arena."""
    packed, counts, win, n_pad, _ = _native.pack_blocked(
        start, end, n, W, B, L, cap_multiple=chunk
    )
    return packed.copy(), counts.copy(), win, n_pad


def _target(start, end, n_pad, m, W, win):
    return _native.capped_target(start, end, n_pad, m).reshape(W, win)


def _uniform(seed, n=900, reads=800, span=48):
    rng = np.random.default_rng(seed)
    batch = rand_reads_uniform(rng, reads, n, span)
    return np.asarray(batch.start, np.int64), np.asarray(batch.end, np.int64)


def _clumped():
    """All reads near the genome start: later blocks and windows are empty."""
    rng = np.random.default_rng(3)
    start = rng.integers(0, 40, 300)
    return start, start + rng.integers(5, 32, 300) - 1


def _oracle(start, end, n_pad, m, L):
    """The global sequential sweep (torch), sel_per_end[n_pad]."""
    s = torch.from_numpy(start)
    e = torch.from_numpy(end)
    ones = torch.ones(len(start), dtype=torch.int32)
    rows = build_start_rows(s, e - s + 1, ones, n_pad, L)
    tgt = capped_coverage(coverage_from_intervals(s, e, n_pad), m)
    z = torch.zeros(L, dtype=torch.int32)
    return sweep_counts(rows, tgt, z, z, L)[0].numpy()


@pytest.mark.parametrize(
    "auto,grid_offset,seeded",
    [
        (False, 0, False),
        (True, 0, False),
        (True, 2, False),
        (False, 1, True),
        (True, 0, True),
    ],
)
def test_sweep_pass_plain_matches_pallas(auto, grid_offset, seeded):
    start, end = _uniform(0)
    n = 900
    packed, counts, win, n_pad = _pack(start, end, n, W, B, L, CHUNK)
    m = 5
    target = None if auto else _target(start, end, n_pad, m, W, win)
    rng = np.random.default_rng(17)
    if seeded:
        a0, s0, ai0 = (rng.integers(0, 4, (W, L)).astype(np.int32) for _ in range(3))
    else:
        a0 = s0 = ai0 = np.zeros((W, L), np.int32)

    ref = jax_blocked.blocked_sweep_pass(
        jnp.asarray(packed), jnp.asarray(counts),
        None if auto else jnp.asarray(target),
        jnp.asarray(a0), jnp.asarray(s0), W, B, L, CHUNK, True,
        grid_offset=grid_offset, avail0i=jnp.asarray(ai0),
        auto_target=auto, max_coverage=m if auto else 0,
    )
    got = blocked.blocked_sweep_pass(
        torch.from_numpy(packed), torch.from_numpy(counts),
        None if auto else torch.from_numpy(target),
        torch.from_numpy(a0), torch.from_numpy(s0), W, B, L,
        grid_offset=grid_offset, avail0i=torch.from_numpy(ai0),
        auto_target=auto, max_coverage=m if auto else 0,
    )
    assert got[0].shape == (W, (packed.shape[0] - grid_offset) * B)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize(
    "case,auto,m",
    [("uniform0", False, 3), ("uniform1", True, 7), ("clumped", False, 4),
     ("clumped", True, 4)],
)
def test_windowed_sweep_matches_pallas_and_oracle(case, auto, m):
    if case == "clumped":
        start, end = _clumped()
        n, w, b, ll, chunk = 512, 4, 32, 32, 32
    else:
        start, end = _uniform(int(case[-1]))
        n, w, b, ll, chunk = 900, W, B, L, CHUNK
    packed, counts, win, n_pad = _pack(start, end, n, w, b, ll, chunk)
    target = None if auto else _target(start, end, n_pad, m, w, win)

    ref_sel, ref_rounds = jax_blocked.blocked_windowed_sweep(
        jnp.asarray(packed), jnp.asarray(counts),
        None if auto else jnp.asarray(target), w, b, ll, chunk, True,
        auto_target=auto, max_coverage=m if auto else 0,
    )
    sel, rounds = blocked.blocked_windowed_sweep(
        torch.from_numpy(packed), torch.from_numpy(counts),
        None if auto else torch.from_numpy(target), w, b, ll,
        auto_target=auto, max_coverage=m if auto else 0,
    )
    np.testing.assert_array_equal(sel.numpy(), np.asarray(ref_sel))
    assert rounds == int(ref_rounds)
    assert 1 <= rounds <= w + 1
    np.testing.assert_array_equal(sel.numpy(), _oracle(start, end, n_pad, m, ll))


def test_expand_flat_codes_restores_padded_layout():
    start, end = _uniform(2)
    flat, counts, win, _, cap, slots = _native.pack_flat_direct(
        start, end, 900, W, B, L, cap_multiple=CHUNK, cap_floor=2 * CHUNK
    )
    flat, counts, slots = flat.copy(), counts.copy(), slots.copy()
    nbw = win // B
    p32 = blocked.expand_flat_codes(
        torch.from_numpy(flat.view(np.int16)), torch.from_numpy(counts),
        nbw, W, cap,
    ).numpy()
    ref = np.asarray(jax_blocked.expand_flat_codes(
        jnp.asarray(flat), jnp.asarray(counts), nbw, W, cap
    ))
    np.testing.assert_array_equal(p32, ref)
    np.testing.assert_array_equal(p32.reshape(-1)[slots] // L, start % B)
    # a 0xFFFF code (the uint16 sentinel) restores to -1
    probe = torch.tensor([-1, 5], dtype=torch.int16)
    one = torch.tensor([[2]], dtype=torch.int32)
    np.testing.assert_array_equal(
        blocked.expand_flat_codes(probe, one, 1, 1, 4).numpy().reshape(-1),
        [-1, 5, -1, -1],
    )


def test_sweep_pass_rejects_bad_arguments():
    start, end = _uniform(0)
    packed, counts, win, n_pad = _pack(start, end, 900, W, B, L, CHUNK)
    p, c = torch.from_numpy(packed), torch.from_numpy(counts)
    z = torch.zeros((W, L), dtype=torch.int32)
    with pytest.raises(ValueError, match="target is required"):
        blocked.blocked_sweep_pass(p, c, None, z, z, W, B, L)
    with pytest.raises(ValueError, match="grid_offset"):
        blocked.blocked_sweep_pass(
            p, c, None, z, z, W, B, L, grid_offset=packed.shape[0],
            auto_target=True,
        )
    with pytest.raises(ValueError, match="avail0"):
        blocked.blocked_sweep_pass(
            p, c, None, z.long(), z, W, B, L, auto_target=True
        )


def test_max_starts_counts_reads_starting_at_one_position():
    """The CUDA wrapper's uint16 check: the most reads of one (block,
    window) group that start at one position, as numpy counts them."""
    start, end = _uniform(6)
    hot = np.full(700, 3 * B + 17)  # window 0's fourth block
    start = np.concatenate([start, hot])
    end = np.concatenate([end, hot + np.arange(700) % 40])
    packed, counts, win, _ = _pack(start, end, 900, W, B, L, CHUNK)
    window, rel = start // win, start % win
    ref = np.bincount((rel // B * W + window) * B + rel % B).max()
    assert ref >= 700
    assert blocked._max_starts(torch.from_numpy(packed), B, L) == ref
    assert blocked._max_starts(torch.full((2, W, 8), -1, dtype=torch.int32), B, L) == 0


def test_oracle_agrees_with_host_greedy_counts():
    """The torch oracle's per-end counts are those of the exact host
    greedy's selection (same minimum count, same end buckets)."""
    from genome_downsampler_tpu.solvers.native_greedy import native_greedy_select

    start, end = _uniform(4, n=1200, reads=900, span=40)
    sel = native_greedy_select(start, end, 1200, 6)
    per_end = np.bincount(end[sel], minlength=1200)
    np.testing.assert_array_equal(_oracle(start, end, 1200, 6, 64), per_end)
