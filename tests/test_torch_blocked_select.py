"""Kernel C's plain torch twin against the JAX Pallas kernel (interpret
mode) and against the port's argsort engine ``_selection_mask``; the rule
the CUDA kernel C relies on (the packers emit code-sorted groups, stable by
read index) and a numpy model of its decomposition against both.

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


# ---- the rule the CUDA kernel C relies on, and its decomposition

def _geometry(name):
    """(start, end, n, W, B, L, chunk) of the packer geometries: small
    uniform, clumped (many reads per code), config-4-like (W=32, B=128,
    L=256 at 300x, cut to 100 kb) and long reads at L=768 with B=64."""
    rng = np.random.default_rng(7)
    if name == "small":
        start = rng.integers(0, 900 - 48, 1600)
        return start, start + rng.integers(0, 47, 1600), 900, 4, 64, 64, 64
    if name == "clumped":
        start = rng.integers(0, 40, 300)
        return start, start + rng.integers(5, 32, 300) - 1, 512, 4, 32, 32, 32
    if name == "config4":
        n = 100_000
        start = rng.integers(0, n - 150, 200_000)
        return start, start + 149, n, 32, 128, 256, 128
    if name == "long768":
        n = 4 * 16 * 64
        start = rng.integers(0, n - 768, 3000)
        start = np.concatenate([start, np.repeat(start[:100], 3)])
        end = np.concatenate([start[:3000] + rng.integers(0, 767, 3000),
                              np.repeat(start[:100] + 500, 3)])
        return start, end, n, 4, 64, 768, 64
    raise ValueError(name)


@pytest.mark.parametrize("packer", ["flat_direct", "blocked"])
@pytest.mark.parametrize("geometry", ["small", "clumped", "config4", "long768"])
def test_packers_emit_code_sorted_groups_stable_by_index(geometry, packer):
    start, end, n, Wg, Bg, Lg, chunk = _geometry(geometry)
    if packer == "flat_direct":
        flat, counts, win, _, cap, slots = _native.pack_flat_direct(
            start, end, n, Wg, Bg, Lg, cap_multiple=chunk)
        counts, slots = counts.copy(), slots.copy()
        nbw = win // Bg
        packed = blocked.expand_flat_codes(
            torch.from_numpy(flat.view(np.int16).copy()), torch.from_numpy(counts),
            nbw, Wg, cap).numpy()
    else:
        packed, counts, win, _, slots = _native.pack_blocked(
            start, end, n, Wg, Bg, Lg, cap_multiple=chunk)
        packed, counts, slots = packed.copy(), counts.copy(), slots.copy()
        nbw, cap = win // Bg, packed.shape[2]
    group = ((start % win) // Bg) * Wg + start // win
    code = (start % Bg) * Lg + (end - start)
    # each read sits in its group's slot, holding its code ...
    np.testing.assert_array_equal(packed.reshape(-1)[slots], code)
    np.testing.assert_array_equal(slots // cap, group)
    # ... and a group's slots 0..cnt-1 are its reads by (code, read index)
    order = np.lexsort((np.arange(len(start)), code, group))
    g_sorted = group[order]
    first = np.searchsorted(g_sorted, g_sorted)
    np.testing.assert_array_equal(slots[order], g_sorted * cap + np.arange(len(start)) - first)
    np.testing.assert_array_equal(np.bincount(group, minlength=nbw * Wg),
                                  counts.reshape(-1))
    assert (np.diff(packed, axis=2)[packed[:, :, 1:] >= 0] >= 0).all()
    if geometry in ("clumped", "long768"):
        assert np.unique(code[group == group[0]]).size < (group == group[0]).sum()


def _select_model(packed, counts, sel, xwin, W, B, L):
    """The CUDA kernel C's decomposition in numpy: per group (t, w), acc_t
    from the xwin slice and the ends of groups t-K..t-1, then each slot's
    rank = acc_t[end] + the earlier slots of its group with the same end."""
    nbw, _, cap = packed.shape
    win, n_pad = nbw * B, W * nbw * B
    K = 1 + (L - 2) // B
    out = np.zeros(packed.shape, np.int8)

    def ends(t, w):
        c = packed[t, w, :counts[t, w]].astype(np.int64)
        return c // L + c % L

    for t in range(nbw):
        for w in range(W):
            x = np.arange(B + L) + t * B
            acc = np.where(x < B + L, xwin[w, np.minimum(x, B + L - 1)], 0).astype(np.int64)
            for u in range(max(t - K, 0), t):
                e = ends(u, w) - (t - u) * B
                np.add.at(acc, e[e >= 0], 1)
            for s, e in enumerate(ends(t, w)):
                gend = w * win + t * B + e
                out[t, w, s] = acc[e] < (sel[gend] if gend < n_pad else 0)
                acc[e] += 1
    return out


@pytest.mark.parametrize("case", ["duplicates", "long768", "b32", "past_genome"])
def test_select_decomposition_matches_plain_and_pallas(case):
    """Seeded random sel and xwin (the function, not a sweep's output) over
    packed groups: several reads per code, L > B (K = 12 at L=768, B=64;
    K = 4 at L=128, B=32), and reads ending past the padded genome."""
    rng = np.random.default_rng(len(case))
    if case == "duplicates":
        Wc, Bc, Lc, n = 4, 64, 64, 1500
        start = rng.integers(0, n - Lc, 600)
        end = start + rng.integers(0, 20, 600)
        start, end = np.repeat(start, 3), np.repeat(end, 3)
    elif case == "long768":
        Wc, Bc, Lc, n = 4, 64, 768, 4 * 16 * 64
        start = rng.integers(0, n - 768, 2000)
        end = start + rng.integers(0, 767, 2000)
    elif case == "b32":
        Wc, Bc, Lc, n = 3, 32, 128, 3 * 8 * 32
        start = rng.integers(0, n - 128, 900)
        end = start + rng.integers(0, 127, 900)
    else:  # n_pad == n, and reads from the genome's last bases run past it
        Wc, Bc, Lc, n = 2, 64, 128, 2 * 6 * 64
        start = np.concatenate([rng.integers(0, n - 128, 800), n - rng.integers(1, 40, 60)])
        end = start + rng.integers(0, 127, start.size)
    # hot ends: at each, reads from up to L - 1 bases back (from the
    # farthest group the lookback reaches) and short reads of its own group
    hot = rng.integers(Lc, n - 4, 40)
    back = np.concatenate([rng.integers(Lc - 40, Lc - 1, 40), rng.integers(0, 4, 80)])
    start = np.concatenate([start, np.tile(hot, 3) - back])
    end = np.concatenate([end, np.tile(hot, 3)])
    packed, counts, win, n_pad, _ = _native.pack_blocked(start, end, n, Wc, Bc, Lc,
                                                         cap_multiple=64)
    packed, counts = packed.copy(), counts.copy()
    sel = rng.integers(0, 4, n_pad).astype(np.int32)
    xwin = rng.integers(0, 3, (Wc, Bc + Lc)).astype(np.int32)
    if case == "past_genome":
        assert n_pad == n and (end >= n_pad).sum() > 10

    got = _select_model(packed, counts, sel, xwin, Wc, Bc, Lc)
    plain = blocked.blocked_selection_pass_plain(
        torch.from_numpy(packed), torch.from_numpy(counts), torch.from_numpy(sel),
        torch.from_numpy(xwin), Wc, Bc, Lc)
    np.testing.assert_array_equal(got, plain.numpy())
    ref = jax_blocked.blocked_selection_pass(
        jnp.asarray(packed), jnp.asarray(counts), jnp.asarray(sel), jnp.asarray(xwin),
        Wc, Bc, Lc, 64, True,
    )
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert 0 < got.sum() < counts.sum()
