"""Reads longer than 4,094 bases (L above 4,096) on the CPU:

- the port's blocked solver (plain twins) at L = 8,192 against the JAX
  ``BlockedWindowedMcpSolver`` (Pallas interpret mode) and ``mcp-cpu``;
- ``testing/long_reads.py``'s whole-genome long-read sets (``ont_wgs_5mb``,
  ``hifi_chr20``) at a tiny cut through the solver, against ``mcp-cpu``, and
  at their published sizes, their geometry; ``hiv_nfl_9kb`` at its size;
- the wrappers' span rule (``B * L < 2^31``), the wide path's tiers as
  ``ops/csrc/blocked_sweep_wide.cu`` lays them out and kernel C's path as
  ``ops/csrc/blocked_select.cu`` bounds its tile, a forced tier or path;
- Python models of what the kernels add past L = 4,096, against brute force
  or the twins: the wide path's 32-ary tree of live ends (its walk to the
  highest live end in ring order, its set and clear) and kernel C's hash
  path (the group's distinct ends in a linear-probing table, the lookback
  groups streamed, groups ranked half a table at a time).

Every comparison is integer bit-equality; inputs come from numpy seeds.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from genome_downsampler_tpu.core.readbatch import ReadBatch as JaxReadBatch
from genome_downsampler_tpu.solvers.blocked_sweep import (
    BlockedWindowedMcpSolver as JaxBlockedSolver,
)
from genome_downsampler_tpu_torch.ops import blocked
from genome_downsampler_tpu_torch.solvers.blocked_sweep import BlockedWindowedMcpSolver
from genome_downsampler_tpu_torch.solvers.native_greedy import native_greedy_select
from genome_downsampler_tpu_torch.testing import long_reads

CSRC = Path(__file__).resolve().parents[1] / "genome_downsampler_tpu_torch" / "ops" / "csrc"


def _geometry(batch):
    s, e = np.asarray(batch.start, np.int64), np.asarray(batch.end, np.int64)
    span = int((e - s).max()) + 1
    density = len(s) * float(np.mean(e[:4096] - s[:4096] + 1)) / batch.ref_genome_length
    return BlockedWindowedMcpSolver("cpu")._geometry(batch.ref_genome_length, span, density)


# ---- the solver past L = 4,096

@pytest.mark.parametrize("m", [3, 5])
def test_blocked_solver_past_4096_matches_jax_and_host_greedy(m):
    """24,000 bases, 2 windows, 300 reads of 4,100-8,100 bases (L =
    8,192): the JAX solver needs n_windows given, or its geometry refuses a
    window shorter than L."""
    rng = np.random.default_rng(24_000 + m)
    n, r = 24_000, 300
    length = rng.integers(4_100, 8_101, r)
    start = (rng.random(r) * (n - length + 1)).astype(np.int64)
    end = start + length - 1
    batch = JaxReadBatch(
        bam_id=np.arange(r, dtype=np.int64), start=start, end=end,
        quality=np.full(r, 50, np.int64), seq_length=length.astype(np.int64),
        is_first=np.tile([True, False], r // 2), ref_genome_length=n,
    )
    solver = BlockedWindowedMcpSolver("cpu", n_windows=2)
    sel = solver.solve(m, batch)
    assert solver.last_stats["max_span"] == 8192 and solver.last_stats["n_windows"] == 2
    np.testing.assert_array_equal(
        sel, JaxBlockedSolver(n_windows=2, interpret=True).solve(m, batch))
    np.testing.assert_array_equal(sel, native_greedy_select(start, end, n, m))
    assert 0 < len(sel) < r


@pytest.mark.parametrize("kind", ["ont-wgs-5mb", "hifi-chr20"])
def test_whole_genome_read_sets_match_host_greedy_at_a_tiny_cut(kind):
    """Each read set's shape cut to 24,000 bases with reads of at most
    8,100 bases (ont-wgs-5mb: the log-normal lengths clipped to
    1,000-8,100 at 100x; hifi-chr20: lengths uniform in 4,100-8,100 at
    30x), M as phase 3c of chip_smoke.py runs them."""
    rng = np.random.default_rng(12345)
    if kind == "ont-wgs-5mb":
        batch, m = long_reads.ont_wgs_5mb(rng, 24_000, max_len=8_100), 50
    else:
        batch, m = long_reads.hifi_chr20(rng, 24_000, 4_100, 8_100), 20
    start, end = np.asarray(batch.start, np.int64), np.asarray(batch.end, np.int64)
    assert start.min() >= 0 and end.max() < 24_000
    solver = BlockedWindowedMcpSolver("cpu")
    sel = solver.solve(m, batch)
    np.testing.assert_array_equal(sel, native_greedy_select(start, end, 24_000, m))
    assert solver.last_stats["max_span"] > 4096
    assert 0 < len(sel) < batch.n_reads


def test_hiv_nfl_read_set_matches_host_greedy_at_its_size():
    """hiv-nfl-9kb at its published size (20,000 reads over 9,719 bases, M
    = 100 as phase 3c runs it): one window at L = 9,088, the wide path's
    tier 1 and kernel C's tile."""
    b = long_reads.hiv_nfl_9kb(np.random.default_rng(12345))
    start, end = np.asarray(b.start, np.int64), np.asarray(b.end, np.int64)
    length = end - start + 1
    assert b.n_reads == 20_000 and b.ref_genome_length == 9_719
    assert 628 <= start.min() and start.max() <= 648
    assert 8_900 <= length.min() and length.max() <= 9_000 and end.max() < 9_719
    assert _geometry(b)[:3] == (1, 128, 9_088)
    assert blocked.wide_tier(128, 9_088, True)[0] == 1
    assert blocked.select_path(128, 9_088) == "tile"
    solver = BlockedWindowedMcpSolver("cpu")
    sel = solver.solve(100, b)
    np.testing.assert_array_equal(sel, native_greedy_select(start, end, 9_719, 100))
    assert solver.last_stats["max_span"] == 9_088 and 0 < len(sel) < b.n_reads


def test_named_whole_genome_read_sets_have_their_size_and_geometry():
    """At their published sizes: the depth, the length bounds, the reads,
    and the solver's (W, B, L) that phase 3c reports."""
    for make, depth, lo, hi, reads, geometry in (
            (long_reads.ont_wgs_5mb, 100, 1_000, 100_000, 45_528, (32, 128, 100_096)),
            (long_reads.hifi_chr20, 30, 15_000, 25_000, 96_698, (64, 128, 25_088))):
        b = make(np.random.default_rng(12345))
        length = np.asarray(b.end - b.start + 1, np.int64)
        assert b.n_reads == reads and lo <= length.min() and length.max() <= hi
        assert depth <= length.sum() / b.ref_genome_length < depth + hi / b.ref_genome_length
        assert b.start.min() >= 0 and b.end.max() < b.ref_genome_length
        assert _geometry(b)[:3] == geometry
    assert long_reads.hifi_chr20(np.random.default_rng(0)).ref_genome_length == 64_444_167


def test_long_span_pass_offsets_and_coverage():
    """long_span_pass's xwin counts each read of an earlier window ending in
    a window's first B + L positions; capped_coverage is the capped depth."""
    L, W, B = 16_256, 3, 128
    start, end, packed, counts, win, xwin = long_reads.long_span_pass(
        np.random.default_rng(3), L, W, B, hot=50)
    assert counts.sum() == len(start) == 350 and win == 4 * B
    want = np.zeros_like(xwin)
    for s, e in zip(start.tolist(), end.tolist()):
        for w in range(s // win + 1, W):
            if 0 <= e - w * win < B + L:
                want[w, e - w * win] += 1
    np.testing.assert_array_equal(xwin, want)
    cov = np.array([((start <= i) & (end >= i)).sum() for i in range(W * win)])
    np.testing.assert_array_equal(long_reads.capped_coverage(start, end, W * win, 40),
                                  np.minimum(cov, 40))


# ---- the span rule and the wide path's tiers

@pytest.mark.parametrize("B,L", [(128, 4224), (128, 16256), (128, 65536), (256, 100_096),
                                 (128, (1 << 24) - 32)])
def test_cuda_span_rule_admits_long_spans(B, L):
    blocked._check_cuda_span("sweep", B, L)
    blocked._check_cuda_span("selection", B, L)


@pytest.mark.parametrize("B,L", [(128, 1 << 24), (256, 1 << 23), (64, 48), (128, 16)])
def test_cuda_span_rule_refuses_past_the_int32_codes(B, L):
    with pytest.raises(ValueError, match=r"block \* max_span < 2\^31 .*"
                                         rf"max_span={L}, block={B}"):
        blocked._check_cuda_span("sweep", B, L)


def _constant(source, name):
    """The right-hand side of ``constexpr ... name = ...;`` in a source."""
    return re.search(rf"constexpr \w+ {name} = ([^;]+);", source).group(1)


def _source_layouts(src, B, L, auto_target):
    """tier_layout's (shared bytes, workspace words) of each tier, evaluated
    from the source's return statements at (B, L)."""
    body = src[src.index("Tier tier_layout("):]
    body = body[:body.index("\n}\n")]
    R = 1 << (B + L).bit_length() if auto_target else 0
    names = dict(L=L, R=R, T=blocked.tree_words(L), kStaging=blocked._WIDE_STAGING)
    out = {}
    for tier, smem, ws in re.findall(r"return \{(\d), ([^,]+), ([^,]+)\};", body):
        py = [e.replace("sizeof(int32_t)", "4").replace("static_cast<size_t>", "")
              .replace("int64_t{L}", "L").replace("L / 32", "L // 32") for e in (smem, ws)]
        out[int(tier)] = tuple(eval(e, {}, names) for e in py)
    return out


def test_wide_tier_mirrors_the_source():
    """ops/blocked.py's wide_layout is the source's tier_layout, with its
    shared-memory cap, mask span and staging, and wide_tier gives the tiers
    its header names: tier 1 up to L = 16,128 at B = 128 with auto targets
    (202.8 KB), the workspace of 8L + 4R bytes a window above (16 MB at L =
    65,536 and W = 16), the tree in it past about 1.7M."""
    src = (CSRC / "blocked_sweep_wide.cu").read_text()
    assert int(_constant(src, "kMaxSmem")) == blocked._WIDE_MAX_SMEM
    assert int(_constant(src, "kMaskSpan")) == blocked._WIDE_MASK_SPAN
    assert int(_constant(src, "kMaxBlock")) == blocked._CUDA_MAX_BLOCK
    assert _constant(src, "kStaging") == "6 * kMaxBlock + 2"
    assert blocked._WIDE_STAGING == 6 * blocked._CUDA_MAX_BLOCK + 2
    for B, L, auto in ((128, 4096, True), (64, 8192, False), (128, 16_256, True),
                       (256, 100_096, True), (128, 1 << 21, False)):
        layouts = _source_layouts(src, B, L, auto)
        assert sorted(layouts) == [0, 1, 2, 3]
        for t, got in layouts.items():
            assert blocked.wide_layout(t, B, L, auto) == got
    assert blocked.wide_tier(128, 4096, True) == (0, 4 * (8192 + 128 + 1538 + 8192), 0)
    tier, smem, ws = blocked.wide_tier(128, 16_128, True)
    assert (tier, ws) == (1, 0) and 202_000 < smem <= blocked._WIDE_MAX_SMEM
    assert blocked.wide_tier(128, 16_256, True)[0::2] == (2, 2 * 16_256 + 32_768)
    assert blocked.wide_tier(128, 16_256, False)[0::2] == (1, 0)
    assert 16 * 4 * blocked.wide_tier(128, 65_536, True)[2] == 16 * 2**20
    assert blocked.wide_tier(128, 1_700_000 // 32 * 32, False)[0] == 2
    assert blocked.wide_tier(128, 1 << 21, True) == (
        3, 4 * blocked._WIDE_STAGING, 2 * (1 << 21) + (1 << 22) + blocked.tree_words(1 << 21))
    # L = 65,536: 2,048 + 64 + 2 + 1 words (8.45 KB)
    assert blocked.tree_words(65_536) == 2_115 and blocked.tree_words(32) == 1


def test_select_path_mirrors_the_source():
    """Kernel C's tile holds (1 + kWarps) (B + L) ints in the same shared
    memory cap: up to L = 11,488 at B = 128, the hash path above."""
    src = (CSRC / "blocked_select.cu").read_text()
    assert int(_constant(src, "kMaxSmem")) == blocked._WIDE_MAX_SMEM
    assert int(_constant(src, "kWarps")) == blocked._SELECT_WARPS
    assert "sizeof(int32_t) * (1 + kWarps) * (B + L) > kMaxSmem" in src
    assert blocked.select_path(128, 11_488) == "tile"
    assert blocked.select_path(128, 11_520) == "hash"
    assert blocked.select_path(256, 256) == "tile"


@pytest.mark.parametrize("B,L,tier,ok", [
    (128, 4096, 0, True), (128, 4096, 1, False), (128, 4224, 0, False),
    (128, 8192, 1, True), (128, 8192, 3, True), (128, 16_256, 1, False),
    (128, 16_256, 2, True), (128, 1 << 21, 2, False), (128, 8192, 4, False)])
def test_wide_tier_takes_a_forced_tier_at_or_above_its_own(B, L, tier, ok):
    """Tier 0 runs only up to L = 4,096, tiers 1-3 only above; a forced tier
    may not be below the least that fits."""
    if ok:
        assert blocked.wide_tier(B, L, True, tier) == (tier, *blocked.wide_layout(
            tier, B, L, True))
    else:
        with pytest.raises(ValueError, match=rf"got tier={tier}"):
            blocked.wide_tier(B, L, True, tier)


@pytest.mark.parametrize("B,L,path,ok", [
    (128, 256, "hash", True), (128, 8192, "tile", True), (128, 11_520, "tile", False),
    (128, 65_536, "hash", True), (128, 1024, "sort", False)])
def test_select_path_takes_a_forced_path(B, L, path, ok):
    if ok:
        assert blocked.select_path(B, L, path) == path
    else:
        with pytest.raises(ValueError, match=rf"got path='{path}'"):
            blocked.select_path(B, L, path)


def test_forced_tier_and_path_on_the_cpu_run_the_twins():
    """CPU tensors run the plain twins whatever the tier or path, after the
    same checks."""
    W, B, L = 2, 128, 4224
    _, _, packed, counts, _, xwin = long_reads.long_span_pass(np.random.default_rng(7), L, W, B)
    p, c, x = torch.tensor(packed), torch.tensor(counts), torch.tensor(xwin)
    z = torch.zeros((W, L), dtype=torch.int32)
    kw = dict(avail0i=z, auto_target=True, max_coverage=9)
    ref = blocked.blocked_sweep_pass_plain(p, c, None, z, z, W, B, L, **kw)
    got = blocked.blocked_sweep_wide(p, c, None, z, z, W, B, L, tier=3, **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    with pytest.raises(ValueError, match="got tier=0"):
        blocked.blocked_sweep_wide(p, c, None, z, z, W, B, L, tier=0, **kw)
    sel = ref[0].reshape(-1).contiguous()
    assert torch.equal(blocked.blocked_selection_pass(p, c, sel, x, W, B, L, path="hash"),
                       blocked.blocked_selection_pass_plain(p, c, sel, x, W, B, L))


# ---- the wide path's tree of live ends (blocked_sweep_wide.cu)

def _tree_shape(L):
    """tree_shape: each level's first word; level 0 is the mask."""
    lo, n, off = [], L // 32, 0
    while True:
        lo.append(off)
        off += n
        if n == 1:
            break
        n = -(-n // 32)
    return lo + [off]


def _at_or_below(t, lo, q):
    """tree_at_or_below: climb from q's word while the masked word is 0,
    descend by the highest bit."""
    nlev, found = len(lo) - 1, -1
    for j in range(nlev):
        if q < 0:
            return -1
        m = t[lo[j] + (q >> 5)] & ((2 << (q & 31)) - 1)
        if m:
            found, q = j, (q & ~31) + m.bit_length() - 1
            break
        q = (q >> 5) - 1
    if found < 0:
        return -1
    for j in range(found, 0, -1):
        q = 32 * q + t[lo[j - 1] + q].bit_length() - 1
    return q


def _tree_set(t, lo, p):
    for j in range(len(lo) - 1):
        old = t[lo[j] + (p >> 5)]
        t[lo[j] + (p >> 5)] = old | (1 << (p & 31))
        if old:
            return
        p >>= 5


def _tree_clear(t, lo, p):
    for j in range(len(lo) - 1):
        w = t[lo[j] + (p >> 5)] & ~(1 << (p & 31))
        t[lo[j] + (p >> 5)] = w
        if w:
            return
        p >>= 5


@pytest.mark.parametrize("L", [4128, 16256, 65536, 1 << 21])
def test_live_end_tree_finds_the_ring_top(L):
    """Live ends set and cleared one at a time (the arrivals, the takes and
    the expiry): after each change every level's bit says its word below is
    not 0, and the walk from h finds the live end farthest ahead of h (h -
    1 down to 0, then L - 1 down to h) at h = 0, at the live ends and their
    neighbours and at random h."""
    rng = np.random.default_rng(L)
    lo = _tree_shape(L)
    assert len(lo) - 1 <= 7 and lo[-1] == blocked.tree_words(L)
    t = [0] * lo[-1]
    live = set()
    for step in range(300):
        if live and rng.random() < 0.4:
            p = sorted(live)[rng.integers(len(live))]
            live.discard(p)
            _tree_clear(t, lo, p)
        else:
            p = int(rng.integers(L)) if rng.random() < 0.7 else int(rng.integers(64))
            if p not in live:
                live.add(p)
                _tree_set(t, lo, p)
        if step % 30:
            continue
        for j in range(1, len(lo) - 1):
            below = t[lo[j - 1]:lo[j]]
            for i, word in enumerate(below):
                assert bool(t[lo[j] + (i >> 5)] >> (i & 31) & 1) == bool(word)
        hs = {0, L - 1, *map(int, rng.integers(0, L, 20))}
        hs |= {x for p in live for x in (p, (p + 1) % L)}
        for h in hs:
            p = _at_or_below(t, lo, h - 1)
            got = p if p >= 0 else _at_or_below(t, lo, L - 1)
            want = max(live, key=lambda x: (x - h) % L) if live else -1
            assert got == want, (h, got, want)


# ---- kernel C's hash path (blocked_select.cu)

def _hash_home(e, hbits):
    return ((e * 2654435761) & 0xFFFFFFFF) >> (32 - hbits)


def _select_hash_model(packed, counts, sel, xwin, W, B, L, hbits, warps=4):
    """blocked_select_hash_kernel, one group at a time: for each run of H/2
    slots, the distinct ends inserted by linear probing, each entry's acc
    from xwin, the lookback groups' and the group's earlier slots' reads
    ending there; the warps' ranges of whole 32-slot chunks, their counts,
    the scan across warps, the ranks in slot order."""
    nbw, _, cap = packed.shape
    H = 1 << hbits
    win = nbw * B
    K = 1 + (L - 2) // B
    out = np.zeros(packed.shape, np.int8)
    end_of = lambda c: c // L + c % L  # noqa: E731
    for t in range(nbw):
        for w in range(W):
            cnt = int(counts[t, w])
            g = packed[t, w].astype(np.int64)
            for c0 in range(0, cnt, H // 2):
                c1 = min(c0 + H // 2, cnt)
                keys = [-1] * H
                for s in range(c0, c1):
                    e, k = end_of(g[s]), _hash_home(end_of(g[s]), hbits)
                    while keys[k] not in (-1, e):
                        k = (k + 1) % H
                    keys[k] = e

                def find(e):
                    k = _hash_home(e, hbits)
                    while keys[k] != e:
                        if keys[k] == -1:
                            return -1
                        k = (k + 1) % H
                    return k

                acc = [0] * H
                for k, e in enumerate(keys):
                    if e >= 0 and e + t * B < B + L:
                        acc[k] = int(xwin[w, e + t * B])
                stream = [(end_of(x) - (t - u) * B) for u in range(max(t - K, 0), t)
                          for x in packed[u, w, :counts[u, w]].astype(np.int64)]
                stream += [end_of(x) for x in g[:c0]]
                for e in stream:
                    k = find(e) if e >= 0 else -1
                    if k >= 0:
                        acc[k] += 1
                n = c1 - c0
                per = -(-n // (32 * warps)) * 32
                ranges = [(c0 + min(i * per, n), min(c0 + min(i * per, n) + per, c1))
                          for i in range(warps)]
                hist = [[0] * H for _ in range(warps)]
                for i, (a, b) in enumerate(ranges):
                    for s in range(a, b):
                        hist[i][find(end_of(g[s]))] += 1
                for k in range(H):
                    run = acc[k]
                    for i in range(warps):
                        hist[i][k], run = run, run + hist[i][k]
                for i, (a, b) in enumerate(ranges):
                    for s in range(a, b):
                        e = end_of(g[s])
                        k = find(e)
                        gend = w * win + t * B + e
                        quota = int(sel[gend]) if gend < W * win else 0
                        out[t, w, s] = hist[i][k] < quota
                        hist[i][k] += 1
    return out


@pytest.mark.parametrize("L,hbits,hot", [(16_256, 6, 300), (65_536, 13, 0),
                                         (11_520, 7, 600)])
def test_select_hash_path_model_matches_twin(L, hbits, hot):
    """Short windows at long spans (long_span_pass), quotas from the
    windowed sweep's twin; at H = 64 and 128 a group of 300 or 600 reads
    starting at one position is ranked in about 10 rounds of its table."""
    W, B = 2, 128
    start, end, packed, counts, win, xwin = long_reads.long_span_pass(
        np.random.default_rng(L), L, W, B, hot=hot)
    p, c = torch.from_numpy(packed), torch.from_numpy(counts)
    sel, _ = blocked.blocked_windowed_sweep(p, c, None, W, B, L, auto_target=True,
                                            max_coverage=9)
    ref = blocked.blocked_selection_pass_plain(p, c, sel, torch.from_numpy(xwin), W, B, L)
    got = _select_hash_model(packed, counts, sel.numpy(), xwin, W, B, L, hbits)
    np.testing.assert_array_equal(got, ref.numpy())
    assert 0 < int(ref.sum().item()) < len(start)
