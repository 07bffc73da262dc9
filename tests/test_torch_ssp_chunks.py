"""The SSP kernel's decomposition (``csrc/ssp.cu``), emulated in plain
Python on the CPU and held equal to its twin's steps (``ops/ssp.py``:
``_chain_closure`` and ``_bucket_relax``) on seeded inputs.

The kernel cuts the ``n + 1`` nodes into chunks of C, one a CTA, and each
chunk into runs of K nodes, one a thread. A scan publishes each chunk's
aggregate, folds the aggregates of the chunks before it (in scan order) into
a carry, and scans its runs from that carry. A bucket side is run by the
chunk that owns the bucket's destination, reading every source from a
snapshot of d taken before the side. Chunk sizes 1, 7, 256 and larger than
n catch carry and segment mistakes before the kernel runs on a card.
"""

import numpy as np
import pytest
import torch

from genome_downsampler_tpu_torch.ops import ssp
from genome_downsampler_tpu_torch.solvers.device_mcmf import build_convex_buckets

INF, IMAX, KEY = ssp.INF, ssp.IMAX, 1 << 32
NO_KEY = 2**63 - 1


def wrap(x):
    """int32 wrap-around, as the kernel's uint32 adds and torch's int32."""
    return (x + 2**31) % 2**32 - 2**31


def seg(prefix, item):
    """The segmented min combine: ``prefix`` then ``item``, each (flag, key)."""
    (pf, pk), (f, k) = prefix, item
    return f | pf, k if f else min(pk, k)


def chunks(n1, C):
    return [(lo, min(lo + C, n1)) for lo in range(0, n1, C)]


def scan_chunked(items, C, K, combine, ident):
    """Exclusive scan of ``items`` the kernel's way: each chunk's aggregate,
    the carry from the chunks before, each run's aggregate, the exclusive
    fold of the runs before, then the run in order."""
    out = [None] * len(items)
    aggs = []
    for lo, hi in chunks(len(items), C):
        acc = ident
        for x in items[lo:hi]:
            acc = combine(acc, x)
        aggs.append(acc)
    for c, (lo, hi) in enumerate(chunks(len(items), C)):
        carry = ident
        for a in aggs[:c]:
            carry = combine(carry, a)
        runs = chunks(hi - lo, K)
        run_aggs = []
        for a, b in runs:
            acc = ident
            for x in items[lo + a:lo + b]:
                acc = combine(acc, x)
            run_aggs.append(acc)
        for r, (a, b) in enumerate(runs):
            acc = carry
            for ra in run_aggs[:r]:
                acc = combine(acc, ra)
            for q in range(lo + a, lo + b):
                out[q] = acc
                acc = combine(acc, items[q])
    return out


def node_key(d, pi, i):
    return (INF if d >= INF else wrap(d + pi)) * KEY + i


def closure_chunked(d, pk, pid, pi, chainflow, C, K):
    d, pk, pid = list(d), list(pk), list(pid)
    n1 = len(d)
    # reverse: the scan order runs from node n down to 0
    keys = [node_key(d[i], pi[i], i) for i in range(n1)][::-1]
    excl = scan_chunked(keys, C, K, min, NO_KEY)[::-1]
    for i in range(n1):
        mv = excl[i] // KEY
        cand = INF if mv >= INF else wrap(mv - pi[i])
        if cand < d[i]:
            d[i], pk[i], pid[i] = cand, 1, excl[i] % KEY
    flags = [int(i == 0 or chainflow[i - 1] == 0) for i in range(n1)]
    items = [(flags[i], node_key(d[i], pi[i], i)) for i in range(n1)]
    excl = scan_chunked(items, C, K, seg, (0, NO_KEY))
    for i in range(n1):
        if flags[i]:
            continue
        mv = excl[i][1] // KEY
        cand = INF if mv >= INF else wrap(mv - pi[i])
        if cand < d[i]:
            d[i], pk[i], pid[i] = cand, 2, excl[i][1] % KEY
    return d, pk, pid


def relax_chunked(d, pk, pid, pi, flow, net, C):
    """Both bucket sides, each run per chunk over the buckets whose
    destination it owns, in the order and ranges the wrapper builds."""
    bs, be1, off0, cap, pool = (net[k].tolist() for k in ("bs", "be1", "off0", "cap", "pool"))
    d, pk, pid = list(d), list(pk), list(pid)
    n1 = len(d)
    G = len(chunks(n1, C))
    order_f, range_f, _, order_b, range_b, _ = ssp.bucket_ranges(
        net["bs"].int(), net["be1"].int(), n1 - 1, G, C)
    for kind, order, rng in ((3, order_f.tolist(), range_f.tolist()),
                             (4, order_b.tolist(), range_b.tolist())):
        snap = list(d)  # the published snapshot, the twin's dold
        for c, (lo, hi) in enumerate(chunks(n1, C)):
            table = []
            for b in order[rng[c]:rng[c + 1]]:
                fl = flow[b]
                if kind == 3:
                    src, dst, active = bs[b], be1[b], fl < cap[b]
                    rc = wrap(pool[off0[b] + min(fl, cap[b] - 1)] + pi[src] - pi[dst])
                else:
                    src, dst, active = be1[b], bs[b], fl > 0
                    rc = wrap(-pool[off0[b] + max(fl - 1, 0)] + pi[src] - pi[dst])
                assert lo <= dst < hi
                if active and snap[src] < INF:
                    table.append((wrap(snap[src] + rc), dst, b))
            for cand, dst, _ in table:
                if cand < INF:
                    d[dst] = min(d[dst], cand)
            stage = {}
            for cand, dst, b in table:
                if cand < INF and cand == d[dst] and d[dst] < snap[dst]:
                    stage[dst] = min(stage.get(dst, IMAX), b)
            for i in range(lo, hi):
                if d[i] < snap[i]:
                    pk[i], pid[i] = kind, stage[i]
    return d, pk, pid


def _state(seed, n):
    """Seeded reads' buckets on n + 1 nodes, and a mid-phase state: flows,
    potentials, distances (a quarter INF), parents and chain flow."""
    rng = np.random.default_rng(seed)
    r = int(rng.integers(n // 2, 2 * n))
    start = rng.integers(0, n, r)
    end = np.minimum(start + rng.integers(0, max(2, n // 4), r), n - 1)
    bs, be, off, pool, _, _ = build_convex_buckets(start, end, rng.integers(1, 60, r))
    B = bs.shape[0]
    i32 = lambda a: torch.tensor(np.asarray(a, np.int64), dtype=torch.int32)  # noqa: E731
    net = {"bs": i32(bs).long(), "be1": i32(be + 1).long(), "off0": i32(off[:B]),
           "cap": i32(np.diff(off)), "pool": i32(pool)}
    cap = np.diff(off)
    flow = i32(rng.integers(0, cap + 1))
    pi = i32(rng.integers(-500, 500, n + 1))
    d = rng.integers(-200, 2000, n + 1)
    d[rng.random(n + 1) < 0.25] = INF
    pk = i32(rng.integers(0, 5, n + 1))
    pid = i32(rng.integers(0, n + 1, n + 1))
    chainflow = i32(rng.integers(0, 3, n) * (rng.random(n) < 0.6))
    return i32(d), pk, pid, pi, flow, chainflow, net


SIZES = [(1, 1), (7, 3), (256, 1), (256, 4), (10_000, 64)]


@pytest.mark.parametrize("C,K", SIZES)
@pytest.mark.parametrize("seed,n", [(0, 40), (1, 300), (2, 700)])
def test_chunked_closure_equals_the_twin(C, K, seed, n):
    d, pk, pid, pi, _, chainflow, _ = _state(seed, n)
    ref = ssp._chain_closure(d, pk, pid, pi, chainflow)
    got = closure_chunked(d.tolist(), pk.tolist(), pid.tolist(), pi.tolist(),
                          chainflow.tolist(), C, K)
    for g, r in zip(got, ref):
        assert g == r.tolist()


@pytest.mark.parametrize("C", [1, 7, 256, 10_000])
@pytest.mark.parametrize("seed,n", [(3, 40), (4, 300), (5, 700)])
def test_destination_owned_relax_equals_the_twin(C, seed, n):
    d, pk, pid, pi, flow, _, net = _state(seed, n)
    ref = ssp._bucket_relax(d, pk, pid, pi, flow, net)
    got = relax_chunked(d.tolist(), pk.tolist(), pid.tolist(), pi.tolist(),
                        flow.tolist(), net, C)
    for g, r in zip(got, ref):
        assert g == r.tolist()


@pytest.mark.parametrize("n,sms,grid", [(600, 132, (3, 201)), (3_000, 132, (12, 251)),
                                        (29_903, 132, (117, 256)),
                                        (131_072, 132, (132, 993)), (10, 132, (1, 11))])
def test_grid_shape(n, sms, grid):
    G, C = ssp.grid_shape(n, sms)
    assert (G, C) == grid
    # every CTA owns at least one node and the chunks cover 0..n
    assert (G - 1) * C < n + 1 <= G * C


def test_bucket_ranges_cover_each_side_once():
    _, _, _, _, _, _, net = _state(6, 500)
    n = 500
    G, C = ssp.grid_shape(n, 132)
    bs, be1 = net["bs"].int(), net["be1"].int()
    order_f, range_f, _, order_b, range_b, _ = ssp.bucket_ranges(bs, be1, n, G, C)
    for order, rng, owner in ((order_f, range_f, be1), (order_b, range_b, bs)):
        assert sorted(order.tolist()) == list(range(bs.shape[0]))
        assert rng[0] == 0 and rng[-1] == bs.shape[0]
        for c in range(G):
            mine = owner[order[rng[c]:rng[c + 1]].long()]
            assert bool(((mine >= c * C) & (mine < (c + 1) * C)).all())


def test_round_split_finds_every_part_of_the_port_kernel():
    """``scripts/ssp_round_split.py`` stamps the round loop of the port's
    ``ssp.cu`` at its start and after each of its four parts."""
    from pathlib import Path

    from genome_downsampler_tpu_torch.scripts.ssp_round_split import instrument

    src = Path(ssp.__file__).parent / "csrc" / "ssp.cu"
    text, version, names = instrument(src.read_text())
    assert version == "grid" and len(names) == 4
    assert text.count("clock64(); ") == 5 and "gd_split_read" in text
