"""Kernel B's wide path (``ops/csrc/blocked_sweep_wide.cu``) on the CPU:

- its plain twin ``blocked_sweep_pass_plain`` against the JAX Pallas
  kernel (interpret mode) at a long span, L = 1,024;
- a Python model of the kernel's decomposition (per-end counts in a ring
  indexed by the absolute end mod L, a bitmask of the live ends walked from
  the top as the sweep warp walks it, each position's arrivals read as one
  run of its group's start-sorted codes through the producers' offsets,
  which the producers build from contiguous shares of the codes, adding
  each run of equal codes to the coverage ring once; quiet positions
  skipped 32 at a time) against the twin at L in {32, 1,024, 4,096} with
  70,000 reads starting at one position; the producers' shares against
  the offsets and the ring they stand for;
- the read sets of ``testing/long_reads.py`` at a tiny size through the
  blocked solver's CPU twins, against ``mcp-cpu``;
- ``chip_smoke.py --against``'s binding of the wide path's C entry: the
  port's, with its workspace, and its earlier sources', with the
  ``wide_tile`` argument or without the workspace.

Every comparison is integer bit-equality; inputs come from numpy seeds.
"""

import importlib.util
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_downsampler_tpu.ops import pallas_blocked as jax_blocked
from genome_downsampler_tpu_torch import _native
from genome_downsampler_tpu_torch.ops import blocked
from genome_downsampler_tpu_torch.solvers.blocked_sweep import BlockedWindowedMcpSolver
from genome_downsampler_tpu_torch.solvers.native_greedy import native_greedy_select
from genome_downsampler_tpu_torch.testing import long_reads

WORDS_PER_LANE = 4  # L <= 4,096: at most 128 mask words over 32 lanes


def _pack(start, end, n, W, B, L):
    packed, counts, win, n_pad, _ = _native.pack_blocked(start, end, n, W, B, L,
                                                         cap_multiple=64)
    return packed.copy(), counts.copy(), win, n_pad


def _carries(seeded, W, L, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 4, (W, L)).astype(np.int32) if seeded
            else np.zeros((W, L), np.int32) for _ in range(3)]


# ---- (a) the twin against the Pallas kernel at L = 1,024

@pytest.mark.parametrize("auto,grid_offset,seeded", [(True, 0, False), (False, 0, True),
                                                     (True, 1, True), (False, 1, False)])
def test_twin_matches_pallas_at_a_long_span(auto, grid_offset, seeded):
    W, B, L, n = 2, 64, 1024, 4096
    rng = np.random.default_rng(701 + grid_offset)
    length = rng.integers(701, 1024, 600)
    start = rng.integers(0, n - length + 1)
    end = start + length - 1
    packed, counts, win, n_pad = _pack(start, end, n, W, B, L)
    m = 7
    target = None if auto else _native.capped_target(start, end, n_pad, m).reshape(W, win)
    a0, s0, ai0 = _carries(seeded, W, L, 3)
    ref = jax_blocked.blocked_sweep_pass(
        jnp.asarray(packed), jnp.asarray(counts),
        None if auto else jnp.asarray(target), jnp.asarray(a0), jnp.asarray(s0),
        W, B, L, 64, True, grid_offset=grid_offset, avail0i=jnp.asarray(ai0),
        auto_target=auto, max_coverage=m if auto else 0,
    )
    got = blocked.blocked_sweep_pass_plain(
        torch.from_numpy(packed), torch.from_numpy(counts),
        None if auto else torch.from_numpy(target), torch.from_numpy(a0),
        torch.from_numpy(s0), W, B, L, grid_offset=grid_offset,
        avail0i=torch.from_numpy(ai0), auto_target=auto, max_coverage=m if auto else 0,
    )
    assert got[0].any()
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ---- (b) a model of the kernel's decomposition against the twin

def _offsets(codes, B, L):
    """The producers' per-position offsets of one group: ``of[b]`` is the
    index of its first code starting at ``b`` or later. Code ``i`` writes
    ``of[b]`` for ``b`` in ``(start of code i-1, start of code i]``, the
    last code also ``of[b]`` for every ``b`` after its start; each entry is
    written exactly once."""
    of = np.full(B + 1, -1, np.int64)
    cnt = codes.shape[0]
    if cnt == 0:
        of[:] = 0
        return of
    sr = codes // L
    prev = np.concatenate([[-1], sr[:-1]])
    assert (sr >= prev).all(), "codes not sorted by start"
    idx = np.concatenate([np.arange(p + 1, s + 1) for p, s in zip(prev, sr)] +
                         [np.arange(sr[-1] + 1, B + 1)])
    assert np.array_equal(np.sort(idx), np.arange(B + 1))
    of[idx] = np.concatenate([np.repeat(np.arange(cnt), sr - prev),
                              np.full(B - sr[-1], cnt)])
    return of


def _producer_shares(codes, B, L, q0, R, producers=96, loads=8):
    """The producers' offsets and coverage-ring adds of one group, as the
    kernel's producers make them: each takes a contiguous share of the
    codes, ``loads`` at a time, skips a batch equal to its current code,
    and adds each run of equal codes to the ring at once. Returns ``(of,
    ring)``; asserts each ``of`` entry is written once."""
    cnt = len(codes)
    of = [0] * (B + 1) if cnt == 0 else [None] * (B + 1)
    ring = np.zeros(R, np.int64)
    per = -(-cnt // producers)
    for pt in range(producers):
        i0 = min(pt * per, cnt)
        i1 = min(i0 + per, cnt)
        pc = ps = -1
        run = 0
        if 0 < i0 < i1:
            pc = int(codes[i0 - 1])
            ps = min(pc // L, B)
        adds = []
        i = i0
        while i < i1:
            q = [int(codes[i + u]) if i + u < i1 else -1 for u in range(loads)]
            if all(x == pc for x in q):
                run += loads
                i += loads
                continue
            for u in range(loads):
                if q[u] >= 0 and q[u] != pc:
                    adds.append((pc, ps, run))
                    sr = min(q[u] // L, B)
                    for b in range(ps + 1, sr + 1):
                        assert of[b] is None
                        of[b] = i + u
                    pc, ps, run = q[u], sr, 0
                run += q[u] >= 0
            i += loads
        adds.append((pc, ps, run))
        for c, sr, k in adds:
            if k and sr < B:
                ring[(q0 + sr + (c - sr * L) + 1) & (R - 1)] += k
        if i0 < i1 == cnt:
            for b in range(ps + 1, B + 1):
                assert of[b] is None
                of[b] = cnt
    return np.array(of, np.int64), ring


@pytest.mark.parametrize("shape", ["empty", "few", "stacks", "uniform", "past the block"])
def test_producer_shares_match_the_offsets_and_ring(shape):
    """The producers' shares give ``_offsets`` and, per code, one ring add
    at ``q0 + start + span`` (codes starting past the block add none)."""
    rng = np.random.default_rng(len(shape))
    B, L, q0 = 256, 1280, 517
    R = 1 << (B + L).bit_length()
    n = {"empty": 0, "few": 50, "stacks": 20_000, "uniform": 3_000, "past the block": 700}[shape]
    codes = rng.integers(0, B * L, n)
    if shape == "stacks":
        codes[:15_000] = rng.choice(codes[15_000:], 15_000)
    if shape == "past the block":
        codes[-40:] = B * L + rng.integers(0, L, 40)
    codes = np.sort(codes)
    of, ring = _producer_shares(codes, B, L, q0, R)
    np.testing.assert_array_equal(of, _offsets(codes, B, L))
    sr = codes // L
    keep = sr < B
    ref = np.zeros(R, np.int64)
    np.add.at(ref, (q0 + codes[keep] + 1 - (L - 1) * sr[keep]) & (R - 1), 1)
    np.testing.assert_array_equal(ring, ref)


def _top_slot(mk, h, L):
    """The highest live end in ring order (physical slot h - 1 down to 0,
    then L - 1 down to h), found as the sweep warp finds it: lane l keys its
    words l, l + 32, ... (a word's live slots below h outrank every slot at
    or above h), a warp-wide max of the keys, the owner's masked word, its
    highest bit."""
    nw, hw, hlo = L // 32, h >> 5, (1 << (h & 31)) - 1
    keys, words = [0] * 32, [0] * 32
    for lane in range(32):
        for i in range(WORDS_PER_LANE):
            j = lane + 32 * i
            if j >= nw:
                break
            m = mk[j]
            lo = m if j < hw else (m & hlo if j == hw else 0)
            hi = m & ~lo
            key, word = (257 + j, lo) if lo else ((1 + j, hi) if hi else (0, 0))
            if key > keys[lane]:
                keys[lane], words[lane] = key, word
    k = max(keys)
    assert k > 0, "a take with no live end"
    j = k - 257 if k > 256 else k - 1
    return 32 * j + words[j & 31].bit_length() - 1


def _wide_model(packed, counts, target, avail0, selend0, avail0i, W, B, L,
                grid_offset, auto, m):
    """Kernel B's wide path, one window at a time: the quiet positions
    ahead skipped (no arrival, no take, both slots at h empty), else the
    arrivals (one run of the group's codes), the deficit, the take from the
    top of the live ends, the emit and the expiry of slot h; the producers'
    offsets and, under ``auto``, their coverage ring of R slots, from
    ``_producer_shares``."""
    nbw = packed.shape[0]
    npos = (nbw - grid_offset) * B
    R = 1 << (B + L).bit_length()
    out = np.zeros((W, npos), np.int64)
    fins = [np.zeros((W, L), np.int64) for _ in range(3)]
    for w in range(W):
        av = avail0[w].astype(np.int64)
        se = selend0[w].astype(np.int64)
        mk = [sum(1 << b for b in range(32) if av[32 * j + b]) for j in range(L // 32)]
        A, cur, h = int(av.sum()), int(se.sum()), 0
        ring = np.zeros(R, np.int64)
        ring[1:L + 1] = avail0i[w]
        run = int(avail0i[w].sum())
        for c in range(nbw - grid_offset):
            t, q0 = grid_offset + c, c * B
            codes = packed[t, w, :counts[t, w]].astype(np.int64)
            of, adds = _producer_shares(codes, B, L, q0, R)
            if auto:
                ring += adds
                tg = []
                for i in range(B):
                    slot = (q0 + i) & (R - 1)
                    run += int(of[i + 1] - of[i]) - int(ring[slot])
                    ring[slot] = 0
                    tg.append(min(run, m))
            else:
                tg = target[w, t * B:(t + 1) * B]
            b = 0
            while b < B:
                # the lookahead: the quiet positions from b on (at most 32)
                # only emit 0 and advance h
                k = 0
                while (k < 32 and b + k < B and of[b + k + 1] == of[b + k]
                       and tg[b + k] <= cur and av[(h + k) % L] == 0
                       and se[(h + k) % L] == 0):
                    k += 1
                if k:
                    b, h = b + k, (h + k) % L
                    continue
                arr = codes[of[b]:of[b + 1]]
                if arr.shape[0]:
                    p = h + arr - b * L
                    p = np.where(p >= L, p - L, p)
                    np.add.at(av, p, 1)
                    for x in np.unique(p).tolist():
                        mk[x >> 5] |= 1 << (x & 31)
                    A += arr.shape[0]
                taken = min(max(int(tg[b]) - cur, 0), A)
                rem = taken
                while rem > 0:
                    p = _top_slot(mk, h, L)
                    x = min(int(av[p]), rem)
                    av[p] -= x
                    se[p] += x
                    rem -= x
                    if av[p] == 0:
                        mk[p >> 5] &= ~(1 << (p & 31))
                e, a = int(se[h]), int(av[h])
                out[w, q0 + b] = e
                cur += taken - e
                A -= taken + a
                av[h] = se[h] = 0
                mk[h >> 5] &= ~(1 << (h & 31))
                h = h + 1 if h + 1 < L else 0
                b += 1
        k = (h + np.arange(L)) % L
        fins[0][w], fins[1][w] = av[k], se[k]
        fins[2][w] = ring[(npos + 1 + np.arange(L)) & (R - 1)] if auto else avail0i[w]
    return [out, *fins]


@pytest.mark.parametrize("auto,grid_offset,seeded,m", [(True, 0, False, 9),
                                                       (False, 1, True, 9),
                                                       (True, 1, True, 80_000)])
@pytest.mark.parametrize("L", [32, 1024, 4096])
def test_wide_path_model_matches_twin(L, auto, grid_offset, seeded, m):
    """Windows of 2 L positions (the ring turns twice), about 2 reads
    starting a position with spans 1..L-1, and 70,000 more of window 1
    starting at one position with spans spread over the ring."""
    W, B = 2, 64 if L == 32 else 128
    win = max(2 * L, 4 * B)
    n = W * win
    rng = np.random.default_rng(L + grid_offset)
    start = rng.integers(0, n - L, 2 * n)
    end = start + rng.integers(0, L - 1, 2 * n)
    hot = win + 2 * B + 5
    start = np.concatenate([start, np.full(70_000, hot)])
    end = np.concatenate([end, hot + rng.integers(0, L - 1, 70_000)])
    packed, counts, win, n_pad = _pack(start, end, n, W, B, L)
    assert np.bincount(start).max() >= 70_000
    target = None if auto else _native.capped_target(start, end, n_pad, m).reshape(W, win)
    carries = _carries(seeded, W, L, L)
    got = _wide_model(packed, counts, target, *carries, W, B, L, grid_offset, auto, m)
    ref = blocked.blocked_sweep_pass_plain(
        torch.from_numpy(packed), torch.from_numpy(counts),
        None if auto else torch.from_numpy(target),
        *(torch.from_numpy(x) for x in carries[:2]), W, B, L, grid_offset=grid_offset,
        avail0i=torch.from_numpy(carries[2]), auto_target=auto,
        max_coverage=m if auto else 0,
    )
    assert ref[0].any()
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r.numpy())


def test_top_slot_follows_the_ring_order():
    """Every rotation h of a ring with a few live ends: the walk's slot is
    the live end farthest ahead of h."""
    L = 1024
    rng = np.random.default_rng(9)
    live = rng.choice(L, 6, replace=False).tolist()
    mk = [0] * (L // 32)
    for p in live:
        mk[p >> 5] |= 1 << (p & 31)
    for h in range(L):
        assert _top_slot(mk, h, L) == max(live, key=lambda p: (p - h) % L)


# ---- (c) the long-read generators through the blocked solver's twins

@pytest.mark.parametrize("kind", ["amplicons", "uniform", "deep amplicon pairs"])
def test_long_read_sets_match_host_greedy_at_a_tiny_size(kind):
    rng = np.random.default_rng(12345)
    if kind == "amplicons":  # midnight-30kb's amplicons, fewer and shallower
        batch = long_reads.amplicon_reads(rng, 4_000, 3, 1_030, 3_000, 25, 1_150, 1_250)
        m, L = 100, 1280
    elif kind == "uniform":  # long-5mb's lengths on a shorter genome
        batch = long_reads.uniform_long_reads(rng, 12_000, 400, 1_000, 3_000)
        m, L = 50, 3072
    else:  # artic-deep-30kb's amplicons, two of them, as deep at the primers
        batch = long_reads.amplicon_pairs(rng, 1_000, 2, 30, 300, 400, 132_000, 100, 150)
        assert np.bincount(batch.start).max() > 65_535
        assert np.array_equal(batch.is_first, np.arange(batch.n_reads) % 2 == 0)
        m, L = 1000, 256
    start, end = np.asarray(batch.start, np.int64), np.asarray(batch.end, np.int64)
    assert start.min() >= 0 and end.max() < batch.ref_genome_length
    solver = BlockedWindowedMcpSolver("cpu")
    sel = solver.solve(m, batch)
    np.testing.assert_array_equal(
        sel, native_greedy_select(start, end, batch.ref_genome_length, m))
    assert solver.last_stats["max_span"] == L
    assert 0 < len(sel) < batch.n_reads


def test_named_long_read_sets_have_their_geometry():
    """midnight-30kb, long-5mb and artic-deep-30kb at their published sizes
    take the blocked solver's W, B, L that phase 3c of chip_smoke.py reports
    (artic-deep-30kb from a cut of its pairs: its 29,903 bases are far
    below the 1 Mb where the solver reads the depth)."""
    for make, geometry in ((long_reads.midnight_30kb, (8, 256, 1280)),
                           (long_reads.long_5mb, (64, 128, 3072)),
                           (lambda rng: long_reads.artic_deep_30kb(rng, 98_000), (8, 256, 256))):
        b = make(np.random.default_rng(12345))
        s, e = np.asarray(b.start, np.int64), np.asarray(b.end, np.int64)
        span = int((e - s).max()) + 1
        density = len(s) * float(np.mean(e[:4096] - s[:4096] + 1)) / b.ref_genome_length
        got = BlockedWindowedMcpSolver("cpu")._geometry(b.ref_genome_length, span, density)
        assert got[:3] == geometry


def test_artic_deep_stacks_exceed_uint16_at_every_primer():
    """artic-deep-30kb's pairs spread evenly over its 98 amplicons: at its
    published size more than 65,535 first mates start at each primer site,
    so every blocked pass takes the wide path; first mates start there,
    second mates end 399 bases on."""
    pairs = inspect.signature(long_reads.artic_deep_30kb).parameters["pairs"].default
    assert pairs // 98 > 65_535
    b = long_reads.artic_deep_30kb(np.random.default_rng(12345), 98 * 50)
    s, e = np.asarray(b.start, np.int64), np.asarray(b.end, np.int64)
    primers = 30 + 300 * np.arange(98)
    np.testing.assert_array_equal(np.bincount(s[0::2], minlength=29_903)[primers], 50)
    np.testing.assert_array_equal(np.unique(e[1::2]), primers + 399)
    assert (e - s + 1).min() >= 100 and (e - s + 1).max() <= 150 and e.max() < 29_903


# the wide path's C entry as its earlier sources declared it: the port's
# arguments, then wide_tile
WIDE_TILE_ENTRY = """
extern "C" int gd_blocked_sweep_wide(
    const void* counts, const void* packed, const void* target, const void* avail0,
    const void* selend0, const void* avail0i, void* out, void* availf, void* selendf,
    void* availfi, int64_t nbw, int64_t W, int64_t cap, int64_t B, int64_t L,
    int64_t grid_offset, int64_t auto_target, int64_t max_coverage, int64_t wide_tile,
    void* stream) {
  return 0;
}
"""


# and as the sources up to L = 4,096 declared it: gd_blocked_sweep's arguments
NO_WORKSPACE_ENTRY = WIDE_TILE_ENTRY.replace("void* availfi, ", "void* availfi,").replace(
    "int64_t max_coverage, int64_t wide_tile,", "int64_t max_coverage,")


@pytest.mark.parametrize("source", ["port", "without the path"])
def test_against_binds_kernel_c_with_and_without_the_path(tmp_path, source):
    """Kernel C's entry takes its path (tile or hash) from the caller; the
    sources up to L = 4,096 chose it themselves."""
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("_chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from genome_downsampler_tpu_torch.ops import build

    text = (root / "genome_downsampler_tpu_torch" / "ops" / "csrc" / "blocked_select.cu"
            ).read_text()
    if source != "port":
        text = text.replace("int64_t L, int64_t hash,", "int64_t L,")
    path = tmp_path / "other.cu"
    path.write_text(text)
    assert cs.against_entry(path) == "gd_blocked_select"
    sig = cs.against_signature(path, "gd_blocked_select")
    if source == "port":
        assert sig == build._SIGNATURES["gd_blocked_select"] and len(sig) == 12
    else:
        assert sig == cs.SELECT_NO_PATH_SIGNATURE and len(sig) == 11


@pytest.mark.parametrize("source", ["port", "with wide_tile", "without a workspace"])
def test_against_binds_the_wide_entry_with_and_without_wide_tile(tmp_path, source):
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("_chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from genome_downsampler_tpu_torch.ops import build

    path = tmp_path / "other.cu"
    text = {"with wide_tile": WIDE_TILE_ENTRY, "without a workspace": NO_WORKSPACE_ENTRY}
    path.write_text(text.get(source) or (
        root / "genome_downsampler_tpu_torch" / "ops" / "csrc" / "blocked_sweep_wide.cu"
    ).read_text())
    assert cs.against_entry(path) == "gd_blocked_sweep_wide"
    sig = cs.against_signature(path, "gd_blocked_sweep_wide")
    if source == "port":
        # gd_blocked_sweep's arguments with the workspace, its bytes and the tier
        assert sig == build._SIGNATURES["gd_blocked_sweep_wide"] and len(sig) == 22
        assert sig[:10] + sig[11:19] + sig[21:] == build._SIGNATURES["gd_blocked_sweep"]
    elif source == "with wide_tile":
        assert sig == cs.WIDE_TILE_SIGNATURE and len(sig) == 20
    else:
        assert sig == cs.WIDE_NO_WS_SIGNATURE == build._SIGNATURES["gd_blocked_sweep"]
