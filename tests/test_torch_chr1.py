"""Config-5's pipeline (``genome_downsampler_tpu_torch.scripts.bench_chr1``
and ``ops.device_pack``) against the JAX package's ``scripts/bench_chr1.py``,
on the CPU.

The JAX script runs unedited, loaded by path, with its module's ``N`` and
``W`` shrunk and ``blocked_windowed_sweep`` wrapped to run its Pallas
kernel with ``interpret=True`` and record what it is given and returns.
The case (15,000 reads over 30,000 bases, W = 4, M = 30: 75x) selects
6,027 reads, fewer than it has. Every comparison is integer equality.
"""

import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from genome_downsampler_tpu.ops import pallas_blocked as jax_blocked
from genome_downsampler_tpu_torch.ops import device_pack
from genome_downsampler_tpu_torch.ops.blocked import blocked_windowed_sweep
from genome_downsampler_tpu_torch.scripts import bench_chr1

ROOT = Path(__file__).resolve().parents[1]
N, WINDOWS, READS, M = 30_000, 4, 15_000, 30
GEOMETRY = dict(block=bench_chr1.B, span=bench_chr1.L, cap=bench_chr1.CAP,
                read_len=bench_chr1.READ_LEN)


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "_jax_script_bench_chr1", ROOT / "scripts" / "bench_chr1.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _main_output(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


@pytest.fixture(scope="module")
def jax_run():
    """The JAX script's ``main()`` at the small case: the ``packed`` and
    ``target`` its kernel B was given, its ``sel`` and ``rounds``, and the
    printed fill and counts."""
    mod = _load_script()
    mod.N, mod.W = N, WINDOWS
    rec = {}
    real = jax_blocked.blocked_windowed_sweep

    def recorded(*a, **kw):
        sel, rounds = real(*a, **{**kw, "interpret": True})
        rec.update(packed=np.asarray(a[0]), target=np.asarray(a[2]),
                   sel=np.asarray(sel), rounds=int(rounds))
        return sel, rounds

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_blocked, "blocked_windowed_sweep", recorded)
        mp.setattr(sys, "argv", ["bench_chr1.py", str(READS / 1e6), str(M)])
        out = _main_output(mod.main)
    rec["fill"] = int(re.search(r"max group fill=(\d+)", out).group(1))
    rec["oracle"] = int(re.search(r"greedy: .*selected=(\d+)", out).group(1))
    rec["selected"] = int(re.search(r"rounds=\d+ selected=(\d+)", out).group(1))
    return rec


@pytest.fixture(scope="module")
def port_pack():
    packed, counts, diff, fill = device_pack.pack_reads(READS, N, WINDOWS, "cpu", **GEOMETRY)
    return packed, counts, device_pack.capped_target(diff, M, WINDOWS), fill


@pytest.mark.parametrize("n", [N, bench_chr1.N])
def test_weyl_streams_equal_the_scripts(monkeypatch, n):
    """The port's host copies and the card's int64 stream (the product
    masked to 32 bits, which wraps from the third read on) against the
    script's uint32 numpy."""
    mod = _load_script()
    monkeypatch.setattr(mod, "N", n)
    r = 300_000
    starts = bench_chr1.host_starts(r, n)
    np.testing.assert_array_equal(starts, mod.host_starts(r))
    np.testing.assert_array_equal(bench_chr1.host_quality(r), mod.host_quality(r))
    np.testing.assert_array_equal(
        device_pack.weyl_starts(r, n, bench_chr1.READ_LEN, "cpu").numpy(), starts)


def test_twin_pack_equals_the_scripts_build(jax_run, port_pack):
    packed, counts, target, fill = port_pack
    jp = jax_run["packed"]
    assert jp.shape == tuple(packed.shape) == (N // WINDOWS // 128 + 1, WINDOWS, 128)
    # each group's codes ascending, pads last
    big = np.iinfo(np.int32).max
    want = np.sort(np.where(jp < 0, big, jp), axis=-1)
    np.testing.assert_array_equal(np.where(want == big, -1, want), packed.numpy())
    np.testing.assert_array_equal((jp >= 0).sum(-1), counts.numpy())
    np.testing.assert_array_equal(jax_run["target"], target.numpy())
    assert fill == jax_run["fill"] == int(counts.max())
    assert int(counts.sum()) == READS


def test_port_solve_on_the_twin_pack_equals_the_scripts(jax_run, port_pack):
    packed, counts, target, _ = port_pack
    sel, rounds = blocked_windowed_sweep(packed, counts, target, WINDOWS, 128, 256)
    np.testing.assert_array_equal(sel.numpy(), jax_run["sel"])
    assert rounds == jax_run["rounds"] > 1
    assert int(sel.sum()) == jax_run["selected"] == jax_run["oracle"] < READS


def test_run_on_the_cpu_matches_the_oracle(jax_run):
    res = bench_chr1.run("cpu", READS, M, n=N, windows=WINDOWS, log=lambda *a: None)
    assert res["ok"] and res["valid"] and res["per_end_equal"]
    assert res["selected"] == res["oracle"] == jax_run["selected"] < READS
    assert res["first_difference"] is None
    assert res["rounds"] == jax_run["rounds"] and res["passes"] == res["rounds"] + 1
    assert res["fill"] == jax_run["fill"]
    assert set(res["laps"]) == {"host_gen", "host_greedy", "gen_pack", "target", "solve",
                                "check"}
    assert res["memory_peak_bytes"] is None and res["device"] == "cpu"


def test_run_reports_a_read_the_oracle_lacks(monkeypatch):
    """The checks have teeth: with one read taken out of the oracle, the
    count and the per-end counts differ at that read's end."""
    real = bench_chr1.native_greedy_select
    dropped = {}

    def short(s, e, n, m):
        sel = real(s, e, n, m)
        dropped["end"] = int(e[sel[7]])
        return np.delete(sel, 7)

    monkeypatch.setattr(bench_chr1, "native_greedy_select", short)
    res = bench_chr1.run("cpu", 6_000, M, n=12_000, windows=2, log=lambda *a: None)
    assert not res["ok"] and res["valid"]
    assert res["selected"] == res["oracle"] + 1
    first = res["first_difference"]
    assert first["position"] == dropped["end"] and first["sel"] == first["oracle"] + 1


def test_covers_target_finds_a_base_below_target():
    sel = torch.tensor([0, 2, 0, 0, 1, 0, 0, 0], dtype=torch.int32)
    # read_len 3: coverage at p is sel[p] + sel[p + 1] + sel[p + 2]
    cov = [2, 2, 1, 1, 1, 0, 0, 0]
    assert bench_chr1.covers_target(sel, torch.tensor(cov, dtype=torch.int32), 3)
    cov[2] = 2
    assert not bench_chr1.covers_target(sel, torch.tensor(cov, dtype=torch.int32), 3)


# (reads, genome, W, block, max_span, cap): config-5's shape (60x, W=64,
# B=128, L=256, cap=128) cut to 30 kb; windows ending mid-block with
# n_pad > n; n_pad == n (diff's last entry is -c(n - read_len)); n = 1,000
PACK_GEOMETRIES = [(12_000, 30_000, 64, 128, 256, 128), (1_000, 10_000, 3, 64, 192, 32),
                   (5_000, 8_192, 2, 64, 192, 128), (1_000, 1_000, 2, 64, 192, 128)]
RL = bench_chr1.READ_LEN


def _start_counts(r, n):
    """c(s), each position's starts, by bincount over [0, n_pad + 1)."""
    return np.bincount(device_pack.weyl_starts(r, n, RL, "cpu").numpy(), minlength=n)


def _emit_block(row, own, back, cap, span):
    """One warp's block as csrc/device_pack.cu writes it: lane l scans
    ceil(B / 32) consecutive counts, the lanes' sums are scanned for the
    offsets, each lane writes its codes at its offset, then the pads. Returns
    the block's diff and count."""
    B = len(own)
    v = -(-B // 32)
    spans = [(min(l * v, B), min(l * v + v, B)) for l in range(32)]
    sums = np.array([own[lo:hi].sum() for lo, hi in spans])
    off = np.cumsum(sums) - sums
    for (lo, hi), o in zip(spans, off):
        for k in range(lo, hi):
            row[o:min(o + own[k], cap)] = k * span + RL - 1
            o += own[k]
    total = int(sums.sum())
    row[total:] = -1
    return own - back, total


@pytest.mark.parametrize("r,n,w,b,span,cap", PACK_GEOMETRIES)
def test_pack_from_start_counts_equals_the_twin(r, n, w, b, span, cap):
    """The outputs from the start counts alone: a block's row is c(s)
    copies of each position's code in order, then -1; counts the block's
    sum; diff[s] = c(s) - c(s - read_len); fill the largest count."""
    packed, counts, diff, fill = device_pack.pack_reads(
        r, n, w, "cpu", block=b, span=span, cap=cap, read_len=RL)
    win, nbw, n_pad = device_pack.geometry(n, w, b)
    c = np.zeros(n_pad + 1, np.int64)
    c[:n] = _start_counts(r, n)
    back = np.concatenate([np.zeros(RL, np.int64), c[:-RL]])
    np.testing.assert_array_equal(c - back, diff.numpy())
    rows = np.empty((nbw, w, cap), np.int64)
    cnt = np.empty((nbw, w), np.int64)
    for blk in range(w * nbw):
        t, win_w = blk % nbw, blk // nbw
        own = c[blk * b:(blk + 1) * b]
        order = np.repeat(np.arange(b) * span + RL - 1, own)[:cap]
        rows[t, win_w] = np.concatenate([order, np.full(cap - len(order), -1)])
        cnt[t, win_w] = own.sum()
    np.testing.assert_array_equal(rows, packed.numpy())
    np.testing.assert_array_equal(cnt, counts.numpy())
    assert fill == cnt.max() and cnt.sum() == r


def _kernel_plan(r, n, w, b, sms):
    """csrc/device_pack.cu's C entry: (q, rem, P, runs, cs, slices, len)."""
    win, nbw, n_pad = device_pack.geometry(n, w, b)
    m = n - RL + 1
    q, rem = divmod(1 << 32, m)
    blocks, target = w * nbw, 2 * sms
    run = max(4096 // b, 1)
    runs = -(-blocks // run)
    while run > 1 and runs < target:
        run = (run + 1) // 2
        runs = -(-blocks // run)
    p = run * b
    cs = slices = 1
    if q >= 64:
        if runs < target:
            cs = min(8, -(-target // runs))
        slices = -(-4 * 256 // (p + min(RL, p + 1)))
        if slices * cs == 1 and q >= 0xFFFFFFFF:
            slices = 2
    return q, rem, p, runs, cs, slices, -(-(q + 1) // (slices * cs))


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("r,n,w,b,span,cap", PACK_GEOMETRIES)
def test_kernels_runs_and_slices_equal_the_twin(r, n, w, b, span, cap, sms):
    """csrc/device_pack.cu in numpy, launch plan and all: each CTA's run
    with its look-back in the shared-memory layout, each (position, slice)
    item's j range (the slices of a position partition [0, J(s)) once),
    the slices' counts summed as the cluster's atomics sum them, then each
    block written from the layout as one warp writes it. On 132 SMs every
    geometry here splits; on 1 SM the larger ones run unsplit, one thread
    a position over its whole range."""
    win, nbw, n_pad = device_pack.geometry(n, w, b)
    m = n - RL + 1
    q, rem, p, runs, cs, slices, length = _kernel_plan(r, n, w, b, sms)
    assert p + min(RL, p + 1) <= 2 * device_pack.MAX_BLOCK + 1
    # each read's (start, j): its Weyl point is start + j * m
    x = (np.arange(r, dtype=np.uint64) * device_pack.WEYL) % (1 << 32)
    keys = np.sort((x % m) * (q + 1) + x // m)
    rows = np.empty((nbw, w, cap), np.int64)
    cnt_out = np.empty((nbw, w), np.int64)
    diff = np.empty(n_pad + 1, np.int64)
    split = slices * cs > 1
    for run in range(runs):
        a = run * p
        pc = min(p, n_pad - a)
        h = min(RL, pc + 1)
        npos = pc + h
        it = np.arange(npos * slices)
        u = np.tile(np.arange(npos), cs * slices)
        k = np.repeat(np.arange(cs), npos * slices) * slices + np.tile(it // npos, cs)
        if not split:
            assert (k == 0).all() and length >= q + 1
        s = np.where(u < h, a - RL + u, a + u - h)
        live = (s >= 0) & (s < m)
        big_j = q + (s < rem)
        j0 = k * length
        nj = np.where(live & (j0 < big_j), np.minimum(length, big_j - j0), 0)
        covered = np.bincount(u, weights=nj, minlength=npos)
        np.testing.assert_array_equal(covered, np.where(live[:npos], big_j[:npos], 0))
        lo_key = s * (q + 1) + j0
        got = np.searchsorted(keys, lo_key + nj) - np.searchsorted(keys, lo_key)
        cnt = np.bincount(u, weights=np.where(nj > 0, got, 0), minlength=npos).astype(np.int64)
        for blk in range(pc // b):
            g = a // b + blk
            t, win_w = g % nbw, g // nbw
            own = cnt[h + blk * b:h + (blk + 1) * b]
            back = cnt[blk * b:(blk + 1) * b]
            diff[a + blk * b:a + (blk + 1) * b], cnt_out[t, win_w] = _emit_block(
                rows[t, win_w], own, back, cap, span)
        if a + pc == n_pad:
            diff[n_pad] = -cnt[pc]
    packed, counts, want_diff, fill = device_pack.pack_reads(
        r, n, w, "cpu", block=b, span=span, cap=cap, read_len=RL)
    np.testing.assert_array_equal(rows, packed.numpy())
    np.testing.assert_array_equal(cnt_out, counts.numpy())
    np.testing.assert_array_equal(diff, want_diff.numpy())
    assert cnt_out.max() == fill


@pytest.mark.parametrize("r,n", [(READS, N), (2_000_000, bench_chr1.N), (1_000, 1_000)])
def test_weyl_inverse_enumerates_a_positions_starts(r, n):
    """K * K^-1 = 1 mod 2^32, and at sampled positions (the first and last
    read's start, the least and largest start, window and block edges, the
    most-filled position) the i < r among i_j = (s + j m) K^-1 mod 2^32,
    j < J(s), number the reads that start there; i_{j+1} - i_j = m K^-1 and
    i_0(s + 1) - i_0(s) = K^-1, both mod 2^32."""
    two32 = 1 << 32
    inv = device_pack.WEYL_INVERSE
    assert device_pack.WEYL * inv % two32 == 1
    m = n - RL + 1
    starts = device_pack.weyl_starts(r, n, RL, "cpu").numpy()
    values, seen = np.unique(starts, return_counts=True)
    win = device_pack.geometry(n, bench_chr1.W, bench_chr1.B)[0]
    sample = {int(starts[0]), int(starts[-1]), int(values[0]), int(values[-1]),
              int(values[seen.argmax()]), 0, m - 1, min(win, m - 1), win - 1,
              bench_chr1.B - 1, bench_chr1.B, m // 2}
    for s in sorted(sample):
        j = np.arange(len(range(s, two32, m)), dtype=np.uint64)
        i = ((s + j * np.uint64(m)) * np.uint64(inv)) % np.uint64(two32)
        assert int((i < r).sum()) == int((starts == s).sum())
        # the kernel counts the rest: the carries out of i + 2^32 - r
        carries = (i + np.uint64(two32 - r)) >> np.uint64(32)
        assert len(i) - int(carries.sum()) == int((i < r).sum())
        np.testing.assert_array_equal((i[1:] - i[:-1]) % np.uint64(two32),
                                      np.full(len(i) - 1, m * inv % two32, np.uint64))
        assert ((s + 1) * inv - s * inv) % two32 == inv


def test_pack_raises_past_cap():
    with pytest.raises(ValueError, match="more than cap=8"):
        device_pack.pack_reads(READS, N, WINDOWS, "cpu", **{**GEOMETRY, "cap": 8})
    with pytest.raises(ValueError, match="read_len <= min"):
        device_pack.pack_reads(READS, N, WINDOWS, "cpu", **{**GEOMETRY, "span": 128})
    with pytest.raises(ValueError, match="block <= 4096"):
        device_pack.pack_reads(READS, N, 1, "cpu", **{**GEOMETRY, "block": 8192, "span": 150})
    with pytest.raises(ValueError, match="no device pack"):
        device_pack.pack_reads(READS, N, WINDOWS, "meta", **GEOMETRY)


def test_qmcp_equals_the_scripts():
    mod = _load_script()
    r, m = 20_000, M
    out = _main_output(mod.main_qmcp, r, m)
    want = re.search(r"selected=(\d+) cost=(\d+)", out)
    res = bench_chr1.run_qmcp(r, m, log=lambda *a: None)
    assert (res["selected"], res["cost"]) == (int(want.group(1)), int(want.group(2)))
    assert res["valid"] and res["n"] == r * 150 // 60 and res["selected"] < r


def test_entry_point_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_chr1.main(["0.01", "30"])
    assert bench_chr1._args([]) == (100_000_000, 30)
    assert bench_chr1._args(["0.5", "20"]) == (500_000, 20)
