"""Kernel C's plain torch twin against the JAX Pallas kernel (interpret
mode) and against the port's argsort engine ``_selection_mask``.

Integer bit-equality throughout; inputs from a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_downsampler_tpu.ops import pallas_blocked as jax_blocked
from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform
from genome_downsampler_tpu_torch import _native
from genome_downsampler_tpu_torch.ops import blocked
from genome_downsampler_tpu_torch.solvers.blocked_sweep import (
    _cross_window_offsets,
    _selection_mask,
    pack_bits,
)

W, B, L, CHUNK = 4, 64, 64, 64


def _uniform():
    rng = np.random.default_rng(21)
    batch = rand_reads_uniform(rng, 1800, 2500, 60)
    return (np.asarray(batch.start, np.int64), np.asarray(batch.end, np.int64),
            2500)


def _duplicates_and_spill():
    """Clumps of identical reads (one larger than a chunk, so cap > chunk
    and equal-code runs cross chunks) over a uniform background with
    reads ending across window boundaries."""
    rng = np.random.default_rng(11)
    n = 2048
    parts = []
    for ci in range(60):
        s = int(rng.integers(0, n - L))
        sp = int(rng.integers(4, L - 1))
        k = 100 if ci == 0 else int(rng.integers(2, 24))
        parts.append(np.tile([[s, s + sp - 1]], (k, 1)))
    s = rng.integers(0, n - L, 800)
    sp = rng.integers(1, L - 1, 800)
    parts.append(np.stack([s, s + sp - 1], axis=1))
    iv = np.concatenate(parts)
    rng.shuffle(iv)
    return iv[:, 0].astype(np.int64), iv[:, 1].astype(np.int64), n


@pytest.mark.parametrize(
    "data,m", [("uniform", 6), ("stress", 3), ("stress", 11)]
)
def test_selection_plain_matches_pallas_and_argsort(data, m):
    start, end, n = _uniform() if data == "uniform" else _duplicates_and_spill()
    packed, counts, win, _, _ = _native.pack_blocked(
        start, end, n, W, B, L, cap_multiple=CHUNK
    )
    packed, counts = packed.copy(), counts.copy()
    if data == "stress":
        assert packed.shape[2] > CHUNK
    p_t, c_t = torch.from_numpy(packed), torch.from_numpy(counts)
    sel, _ = blocked.blocked_windowed_sweep(
        p_t, c_t, None, W, B, L, auto_target=True, max_coverage=m
    )
    xwin = _cross_window_offsets(start, end, win, W, B, L)
    assert xwin.sum() > 0  # some reads end in the next window

    got = blocked.blocked_selection_pass(
        p_t, c_t, sel, torch.from_numpy(xwin), W, B, L
    )
    assert got.dtype == torch.int8 and got.shape == packed.shape
    ref = jax_blocked.blocked_selection_pass(
        jnp.asarray(packed), jnp.asarray(counts), jnp.asarray(sel.numpy()),
        jnp.asarray(xwin), W, B, L, CHUNK, True,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    bits, n_sel = _selection_mask(p_t, sel, W, B, L, win)
    np.testing.assert_array_equal(pack_bits(got).numpy(), bits.numpy())
    assert int(got.sum()) == n_sel > 0


def test_pack_bits_is_little_endian():
    b = torch.tensor([1, 0, 0, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0],
                     dtype=torch.int8)
    np.testing.assert_array_equal(pack_bits(b).numpy(), [0x81, 0x02])
    np.testing.assert_array_equal(
        np.unpackbits(pack_bits(b).numpy(), bitorder="little"), b.numpy()
    )


def test_cross_window_offsets_counts_spilling_reads():
    # window length 100: a read 95..104 ends at window-1-relative 4
    start = np.array([95, 10, 195, 150], np.int64)
    end = np.array([104, 20, 230, 160], np.int64)
    xw = _cross_window_offsets(start, end, 100, 3, 32, 64)
    assert xw.shape == (3, 96) and xw.sum() == 2
    assert xw[1, 4] == 1 and xw[2, 30] == 1
