"""The push-relabel kernel's decomposition (``csrc/push_relabel.cu``),
emulated in plain Python on the CPU and held equal to its twin
(``solvers/push_relabel.py``) on seeded inputs.

The distance closure: the kernel cuts the ``n + 1`` line nodes into chunks
of C, one a CTA, and each chunk into runs of K nodes, one a thread. Before
a round's record barrier each chunk scans itself with no carry: the
prefix-min of ``d(j) - j`` gives the carry-free downward closure D, the
reverse scan of ``min(D(j) + j, BIG)`` (segmented at zero chain flow) each
node's in-chunk suffix and whether its run reaches the chunk's upper end;
it publishes one record (down aggregate, segment flag, up aggregate) and
those words. After the barrier the records give every chunk's carry, its
up aggregate ``min(X, carry + 2 lo)`` (saturated at BIG) and the fold of
the chunks after it, and so any node's post-closure d from its words. The
hops are owned by the tail's chunk, over one entry a residual ``(tail,
other end)`` group: the forward hop reads the other end's post-closure d
from its words, the backward hop a snapshot after the forward hop. Chunk
sizes 1, 7, 256 and larger than n, with one and several nodes a thread,
inputs full of BIG and seeds that reach nothing (the twin's ``BIG - i``),
held round by round to a per-round reference that ends where
``dist_closure`` ends.

The superstep: a warp walks each eligible node's segment of the wrapper's
arc table 32 arcs at a time, with an int64 prefix of what the admissible
arcs want, or, where the segment is long, the whole CTA a tile at a time,
each thread a run of consecutive arcs, the prefix carried across tiles;
heads gain through an accumulator; owners relabel into a second label
buffer. The whole loop (global relabels and supersteps, as the
kernel runs them) is held to the twin's final state after 1, 2 and 30
waves and at convergence; no flow slot may be written twice in a wave, nor
read by an arc that passes the label test after another node wrote it.
Tolerance 0 throughout.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from genome_downsampler_tpu_torch.ops import push_relabel as kernel
from genome_downsampler_tpu_torch.solvers import push_relabel as twin
from genome_downsampler_tpu_torch.testing.long_reads import amplicon_pairs
from genome_downsampler_tpu_torch.testing.flow_cases import (
    BOUNDARY_CASES,
    SUITE_CASES,
    WIDE_TABLES_CASE,
    flow_case,
    flow_inputs,
)

BIG = twin.BIG
NONE = 2**31 - 1
SOURCE = Path(kernel.__file__).parent / "csrc" / "push_relabel.cu"


def chunks(n1, C):
    return [(lo, min(lo + C, n1)) for lo in range(0, n1, C)]


def fold(items, combine, ident):
    acc = ident
    for x in items:
        acc = combine(acc, x)
    return acc


def scan_kernel_way(items, lens, threads, combine, ident):
    """Inclusive scan of ``items`` (in scan order) the kernel's way: cut
    into consecutive chunks of ``lens``, each chunk into runs of
    K = ceil(len / threads), one a thread; each chunk's aggregate, the
    carry from the chunks before, each run's aggregate, the fold of the
    runs before, then the run in order."""
    aggs, pos = [], 0
    for L in lens:
        aggs.append(fold(items[pos:pos + L], combine, ident))
        pos += L
    out, pos = [], 0
    for ci, L in enumerate(lens):
        carry = fold(aggs[:ci], combine, ident)
        K = -(-L // threads)
        runs = [items[pos + k:pos + min(k + K, L)] for k in range(0, L, K)]
        run_aggs = [fold(r, combine, ident) for r in runs]
        for ri, run in enumerate(runs):
            acc = combine(carry, fold(run_aggs[:ri], combine, ident))
            for x in run:
                acc = combine(acc, x)
                out.append(acc)
        pos += L
    return out


def seg(prefix, item):
    """The segmented min combine (``_seg_min``): ``prefix`` then ``item``."""
    (pf, pv), (f, v) = prefix, item
    return pf | f, v if f else min(pv, v)


def compact(table, f_read, want_flow, C):
    """Each chunk's residual groups of one direction (``kernel.HopTable``),
    one entry a group with a residual member, as the kernel compacts them
    at a global relabel: (tail - lo, other end)."""
    members, rng, groups, grange = (x.tolist() for x in table)
    out = []
    for c in range(len(rng) - 1):
        residual = {g for r, g in members[rng[c]:rng[c + 1]] if (f_read[r] > 0) == want_flow}
        out.append([(groups[g][0] - c * C, groups[g][1])
                    for g in range(grange[c], grange[c + 1]) if g in residual])
    return out


def publish(d, flag, C, threads):
    """Each chunk's carry-free scans, as a CTA runs them before the record
    barrier: its record (down aggregate, segment flag, up aggregate) and
    each node's words (D, xs, reaches the chunk's upper end)."""
    records, words = [], [None] * len(d)
    for lo, hi in chunks(len(d), C):
        keys = [BIG if d[i] >= BIG else d[i] - i for i in range(lo, hi)]
        lp = scan_kernel_way(keys, [hi - lo], threads, min, NONE)
        dc = [min(d[i], BIG if lp[i - lo] >= BIG else lp[i - lo] + i) for i in range(lo, hi)]
        x = [BIG if dc[i - lo] >= BIG else min(dc[i - lo] + i, BIG) for i in range(lo, hi)]
        # the reverse scan: each chunk's nodes from its last
        items = [(flag[i], x[i - lo]) for i in range(hi - 1, lo - 1, -1)]
        sm = scan_kernel_way(items, [hi - lo], threads, seg, (0, NONE))[::-1]
        for i in range(lo, hi):
            f, v = sm[i - lo]
            words[i] = (dc[i - lo], v, int(not f))
        records.append((min(keys), sm[0][0], sm[0][1]))
    return records, words


def fold_records(records, C):
    """What every CTA computes from all records after the barrier: each
    chunk's carry and the fold of the chunks after it (the last first) of
    their up aggregates ``min(X, carry + 2 lo)``."""
    carries, acc = [], NONE
    for down, _, _ in records:
        carries.append(acc)
        acc = min(acc, down)
    above, acc = [None] * len(records), (0, NONE)
    for k in range(len(records) - 1, -1, -1):
        above[k] = acc[1]
        f, x = records[k][1:]
        up = x if carries[k] >= BIG or x == NONE else min(x, carries[k] + 2 * k * C)
        acc = seg(acc, (f, up))
    return carries, above


def closed(word, carry, above, i):
    """Node i's post-closure d from its words (the kernel's ``closed``)."""
    dc, xs, reach = word
    down = BIG if carry >= BIG else carry + i
    sm = xs if carry >= BIG else min(xs, carry + 2 * i)
    if reach:
        sm = min(sm, above)
    return min(dc, down, min(sm, BIG) - i)


def closure_kernel_way(d, flag, cf, cb, C, threads):
    """The fixpoint of the closure and the hops from seed ``d``, the
    kernel's way; returns ``(d, rounds, trace)``, ``trace`` d after the
    first closure and after each round."""
    n1 = len(d)
    lows = [lo for lo, _ in chunks(n1, C)]

    def close(d):
        carries, above = fold_records(*publish(d, flag, C, threads)[:1], C)
        words = publish(d, flag, C, threads)[1]
        post = [closed(words[i], carries[i // C], above[i // C], i) for i in range(n1)]
        return post, words, carries, above

    d = close(list(d))[0]
    trace, rounds = [d], 0
    while True:
        d0 = d
        d, words, carries, above = close(d)
        for lo, table in zip(lows, cf):  # the other ends' words
            for tl, o in table:
                x = closed(words[o], carries[o // C], above[o // C], o)
                if x < BIG:
                    d[lo + tl] = min(d[lo + tl], x + 1)
        snap = list(d)
        for lo, table in zip(lows, cb):
            for tl, o in table:
                if snap[o] < BIG:
                    d[lo + tl] = min(d[lo + tl], snap[o] + 1)
        rounds += 1
        trace.append(d)
        if not any(x < y for x, y in zip(d, d0)):
            return d, rounds, trace


def closure_rounds_reference(d, start, end1, rf, rb, flag):
    """The twin's closure and hops, round by round, in numpy: d after the
    first closure and after each round."""
    d = np.asarray(d, np.int64)
    idx = np.arange(d.shape[0])

    def close(d):
        pm = np.minimum.accumulate(np.where(d >= BIG, BIG, d - idx))
        d = np.minimum(d, np.where(pm >= BIG, BIG, pm + idx))
        out, acc = d.copy(), (0, NONE)
        for i in range(d.shape[0] - 1, -1, -1):
            acc = seg(acc, (flag[i], BIG if d[i] >= BIG else d[i] + i))
            out[i] = min(d[i], min(acc[1], BIG) - i)
        return out

    def hops(d):
        de, d = d, d.copy()
        for s, e, ok in zip(start, end1, rf):
            if ok and de[e] < BIG:
                d[s] = min(d[s], de[e] + 1)
        ds = d.copy()
        for s, e, ok in zip(start, end1, rb):
            if ok and ds[s] < BIG:
                d[e] = min(d[e], ds[s] + 1)
        return d

    d = close(d)
    trace = [d.tolist()]
    while True:
        d0, d = d, hops(close(d))
        trace.append(d.tolist())
        if not (d < d0).any():
            return trace


def _closure_inputs(seed, chain, seeds="mixed"):
    """tests/test_torch_push_relabel.py's closure inputs, with the reads'
    flows and validity kept apart (rf = valid & no flow, rb = valid & flow);
    ``seeds`` "big" is a d full of BIG, "cut off" one seed at node n with
    no chain flow (most runs reach nothing: the twin's ``BIG - i``)."""
    rng = np.random.default_rng(seed)
    n, r = 400, 260
    start = rng.integers(0, n - 3, r).astype(np.int32)
    end1 = np.minimum(start + rng.integers(1, 60, r), n).astype(np.int32)
    fr = rng.random(r) < 0.4
    valid = rng.random(r) < 0.9
    draws = rng.random(n + 1)
    d = np.where(draws < 0.03, 1, np.where(draws < 0.06, rng.integers(2, 90, n + 1), BIG))
    if chain == "zero":
        f_chain = np.zeros(n, np.int32)
    elif chain == "positive":
        f_chain = rng.integers(1, 5, n)
    else:
        f_chain = np.where(rng.random(n) < 0.15, 0, rng.integers(1, 5, n)) * (
            (np.arange(n) // 37) % 3 != 0)
    if seeds == "big":
        d = np.full(n + 1, BIG)
    elif seeds == "cut off":
        d = np.full(n + 1, BIG)
        d[n] = 1
    return d.astype(np.int32), start, end1, fr, valid, f_chain.astype(np.int32)


def _closure_both_ways(d, start, end1, fr, valid, f_chain, C, threads):
    n = f_chain.shape[0]
    ref, ref_rounds = twin.dist_closure(
        torch.from_numpy(d), torch.from_numpy(start), torch.from_numpy(end1),
        torch.from_numpy(valid & ~fr), torch.from_numpy(valid & fr), torch.from_numpy(f_chain))
    flag = [int(i == n or f_chain[i] == 0) for i in range(n + 1)]
    trace = closure_rounds_reference(d, start, end1, valid & ~fr, valid & fr, flag)
    assert trace[-1] == ref.tolist() and len(trace) - 1 == ref_rounds
    G = len(chunks(n + 1, C))
    fwd, bwd = kernel.hop_tables(torch.from_numpy(start), torch.from_numpy(end1),
                                 torch.from_numpy(valid), n, G, C)
    f_read = fr.astype(int).tolist()
    got, rounds, got_trace = closure_kernel_way(d.tolist(), flag, compact(fwd, f_read, False, C),
                                                compact(bwd, f_read, True, C), C, threads)
    for k, (a, b) in enumerate(zip(got_trace, trace)):
        assert a == b, f"round {k}"
    assert len(got_trace) == len(trace) and got == ref.tolist() and rounds == ref_rounds


@pytest.mark.parametrize("C,threads", [(1, 256), (7, 256), (7, 2), (256, 256), (405, 256),
                                       (405, 64)])
@pytest.mark.parametrize("chain", ["zero", "positive", "runs"])
@pytest.mark.parametrize("seed", [0, 1])
def test_closure_chunked_equals_dist_closure(seed, chain, C, threads):
    _closure_both_ways(*_closure_inputs(seed, chain), C, threads)


@pytest.mark.parametrize("C,threads", [(1, 256), (7, 2), (256, 256), (405, 64)])
@pytest.mark.parametrize("chain", ["zero", "runs"])
@pytest.mark.parametrize("seeds", ["big", "cut off"])
def test_closure_chunked_equals_dist_closure_where_runs_reach_nothing(seeds, chain, C, threads):
    _closure_both_ways(*_closure_inputs(2, chain, seeds), C, threads)


def test_hop_tables_hold_each_valid_read_once_in_its_tails_chunk():
    _, start, end1, _, valid, _ = _closure_inputs(3, "runs")
    n, C = 400, 7
    G = len(chunks(n + 1, C))
    tables = kernel.hop_tables(torch.from_numpy(start), torch.from_numpy(end1),
                               torch.from_numpy(valid), n, G, C)
    for (members, rng, groups, _), tail, other in zip(tables, (start, end1), (end1, start)):
        rows, b, grp = members.numpy(), rng.tolist(), groups.numpy()
        assert b[0] == 0 and b[-1] == int(valid.sum())
        assert sorted(rows[:b[-1], 0].tolist()) == np.flatnonzero(valid).tolist()
        np.testing.assert_array_equal(grp[rows[:b[-1], 1], 0], tail[rows[:b[-1], 0]])
        np.testing.assert_array_equal(grp[rows[:b[-1], 1], 1], other[rows[:b[-1], 0]])
        for c in range(G):
            assert all(c * C <= t < (c + 1) * C for t in tail[rows[b[c]:b[c + 1], 0]])


@pytest.mark.parametrize("C", [1, 7, 256])
def test_hop_groups_hold_each_pair_once_in_its_tails_chunk_residual_iff_a_member_is(C):
    _, start, end1, fr, valid, _ = _closure_inputs(4, "runs")
    # pile reads onto a few pairs, as amplicon data does
    start[::3], end1[::3] = 17, 60
    n = 400
    G = len(chunks(n + 1, C))
    tables = kernel.hop_tables(torch.from_numpy(start), torch.from_numpy(end1),
                               torch.from_numpy(valid), n, G, C)
    f_read = fr.astype(int).tolist()
    for table, tail, other, want_flow in zip(tables, (start, end1), (end1, start), (False, True)):
        grp, gb = table.groups.numpy(), table.grange.tolist()
        pairs = [tuple(p) for p in grp[gb[0]:gb[-1]].tolist()]
        assert gb[0] == 0 and len(set(pairs)) == len(pairs)
        assert set(pairs) == {(int(t), int(o)) for t, o, v in zip(tail, other, valid) if v}
        for c in range(G):
            assert all(c * C <= t < (c + 1) * C for t, _ in grp[gb[c]:gb[c + 1]].tolist())
        residual = {(int(t), int(o)) for t, o, v, f in zip(tail, other, valid, f_read)
                    if v and (f > 0) == want_flow}
        got = compact(table, f_read, want_flow, C)
        assert sorted((lo + t, o) for (lo, _), es in zip(chunks(n + 1, C), got)
                      for t, o in es) == sorted(residual)
    assert len(pairs) < int(valid.sum())  # the piled reads share a group


def test_wide_tables_case_puts_some_ctas_tables_in_the_workspace():
    """The card tests' case for the hop tables in the workspace: some CTAs
    have more groups in a direction than shared memory holds, others
    fewer, on 132 SMs."""
    start, end, valid, capped, n = flow_inputs(*flow_case(WIDE_TABLES_CASE))
    prep = kernel.prepare(start, end, valid, capped, n, 132)
    groups = torch.maximum(*(t.grange[1:] - t.grange[:-1] for t in (prep["hop_f"], prep["hop_b"])))
    assert int(groups.max()) > kernel._TAB_CAP_MAX >= int(groups.min()) > 0


@pytest.mark.parametrize("name", SUITE_CASES + BOUNDARY_CASES)
def test_kernel_arc_table_is_the_twins_without_padded_reads(name):
    start, end, valid, _, n = flow_inputs(*flow_case(name))
    R = start.shape[0]
    ref = twin.build_arc_table(start, end, n, R)
    arcs, off = kernel.kernel_arc_table(start, end, valid, n)
    is_read = ref.kind <= 1
    padded = is_read & ~valid[torch.where(is_read, ref.slot, 0).long()]
    keep = ~padded & (ref.tails <= n)
    heads, code = arcs[:, 0], arcs[:, 1]
    line = int(off[-1])
    assert torch.equal(heads[:line], ref.heads[keep])
    assert torch.equal(code[:line] & 7, ref.kind[keep])
    assert torch.equal(code[:line] >> 3, ref.slot[keep])
    assert torch.equal(off.long(), torch.searchsorted(ref.tails[keep], torch.arange(n + 2)))


# ---- the superstep and the loop, the kernel's way ----

class Emulated:
    """The kernel's state and its loop, node by node, in Python."""

    def __init__(self, start, end, valid, capped, n, C, threads, cta_walk_arcs=None,
                 tile=(4, 2)):
        self.n, self.C, self.threads = n, C, threads
        # segments of cta_walk_arcs or more (none where None) walked a tile of
        # tile[0] threads of tile[1] consecutive arcs each at a time
        self.cta_walk_arcs, self.tile = cta_walk_arcs, tile
        # arcs read by discharges, by relabels, by CTA walks; CTA discharges
        # whose excess ran out before their tile's last arc
        self.walked = [0, 0, 0]
        self.stops_inside = 0
        self.num_nodes = n + 3
        R = start.shape[0]
        G = len(chunks(n + 1, C))
        self.arcs, self.off = (x.tolist() for x in kernel.kernel_arc_table(
            start, end, valid, n))
        self.hops = kernel.hop_tables(start, end + 1, valid, n, G, C)
        cap_src, cap_snk, st = twin.preflow(capped, n, R)
        self.cap_snk = cap_snk.tolist()
        self.f = {"read": [0] * R, "chain": [0] * n, "src": cap_src.tolist(),
                  "snk": [0] * (n + 1)}
        self.excess, self.label = st.excess.tolist(), st.label.tolist()
        self.step = self.relabels = self.rounds = 0

    # kind -> (flow array, sign of a push)
    KIND = {0: ("read", 1), 1: ("read", -1), 2: ("chain", 1), 3: ("chain", -1),
            4: ("src", -1), 5: ("snk", -1), 6: ("snk", 1)}

    def residual(self, kind, slot):
        name = self.KIND[kind][0]
        f = self.f[name][slot]
        if kind == 0:
            return 1 - f
        if kind == 2:
            return BIG - f
        return self.cap_snk[slot] - f if kind == 6 else f

    def global_relabel(self):
        n, C = self.n, self.C
        fwd, bwd = self.hops
        cf = compact(fwd, self.f["read"], False, C)
        cb = compact(bwd, self.f["read"], True, C)
        flag = [int(i == n or self.f["chain"][i] == 0) for i in range(n + 1)]
        dT0 = [1 if self.cap_snk[i] - self.f["snk"][i] > 0 else BIG for i in range(n + 1)]
        dT, r1, _ = closure_kernel_way(dT0, flag, cf, cb, C, self.threads)
        dS0 = [1 if self.f["src"][i] > 0 else BIG for i in range(n + 1)]
        dS, r2, _ = closure_kernel_way(dS0, flag, cf, cb, C, self.threads)
        for i in range(n + 1):
            self.label[i] = dT[i] if dT[i] < BIG else (
                self.num_nodes + dS[i] if dS[i] < BIG else 2 * self.num_nodes)
        self.relabels += 1
        self.rounds += r1 + r2

    def superstep(self):
        n, cap = self.n, 2 * self.num_nodes
        lab_cur = list(self.label)  # the pre-wave buffer every walk reads
        elig = [self.excess[v] > 0 and (lab_cur[v] & 1) == (self.step & 1)
                for v in range(n + 1)]
        acc_in = [0] * self.num_nodes
        out = [0] * (n + 1)
        written = set()
        def wants(v, arcs):
            want = []
            for a in arcs:
                head, code = self.arcs[a]
                r = self.residual(code & 7, code >> 3)
                ok = lab_cur[v] == lab_cur[head] + 1
                # the label test passes only where no other node writes
                assert not ok or (self.KIND[code & 7][0], code >> 3) not in written
                want.append(r if ok and r > 0 else 0)
            return want

        def push(a, amt):
            head, code = self.arcs[a]
            name, sign = self.KIND[code & 7]
            key = (name, code >> 3)
            assert key not in written, f"flow slot {key} written twice in a wave"
            written.add(key)
            self.f[name][code >> 3] += sign * amt
            acc_in[head] += amt

        for v in (v for v in range(n + 1) if elig[v]):
            a0, a1 = self.off[v], self.off[v + 1]
            rem = self.excess[v]
            if self.long(v):
                rem = self.discharge_cta(v, a0, a1, rem, wants, push)
            else:
                for base in range(a0, a1, 32):
                    lanes = range(base, min(base + 32, a1))
                    want = wants(v, lanes)
                    incl = np.cumsum(np.asarray(want, np.int64)).tolist()
                    for a, w, s in zip(lanes, want, incl):
                        amt = min(max(rem - (s - w), 0), w)
                        if amt > 0:
                            push(a, amt)
                    rem -= incl[-1]
                    self.walked[0] += len(lanes)
                    if rem <= 0:
                        break
            out[v] = self.excess[v] - max(rem, 0)
        relabel = []
        for v in range(n + 1):
            self.excess[v] += acc_in[v] - out[v]
            if elig[v] and out[v] == 0 and self.excess[v] > 0:
                relabel.append(v)
        for v in (n + 1, n + 2):
            self.excess[v] += acc_in[v]
        for v in relabel:  # the next buffer; heads from the pre-wave one
            m = cap
            for head, code in self.arcs[self.off[v]:self.off[v + 1]]:
                if self.residual(code & 7, code >> 3) > 0:
                    m = min(m, lab_cur[head])
            self.label[v] = min(m + 1, cap)
            length = self.off[v + 1] - self.off[v]
            self.walked[1] += length
            self.walked[2] += length if self.long(v) else 0
        self.step += 1

    def long(self, v):
        return (self.cta_walk_arcs is not None
                and self.off[v + 1] - self.off[v] >= self.cta_walk_arcs)

    def discharge_cta(self, v, a0, a1, rem, wants, push):
        """The CTA's walk of node v's segment: each tile's wants, each
        thread's run of them, the exclusive prefix of the threads' sums
        after ``rem`` carried from the tiles before; stops after the tile
        where the excess runs out. Returns the excess left (<= 0 where
        spent)."""
        threads, items = self.tile
        size = threads * items
        base = a0
        while True:
            arcs = range(base, base + size)
            want = wants(v, [a for a in arcs if a < a1]) + [0] * max(base + size - a1, 0)
            sums = [sum(want[t * items:(t + 1) * items]) for t in range(threads)]
            before = 0
            for t in range(threads):
                run = rem - before
                for j in range(items):
                    w = want[t * items + j]
                    amt = min(max(run, 0), w)
                    run -= w
                    if amt > 0:
                        push(base + t * items + j, amt)
                before += sums[t]
            spent_at = next((k for k in range(size) if rem - sum(want[:k + 1]) <= 0), None)
            rem -= before
            base += size
            if rem <= 0 or base >= a1:
                break
        if rem <= 0 and spent_at is not None and spent_at < min(size, a1 - (base - size)) - 1:
            self.stops_inside += 1
        read = min(base, a1) - a0
        self.walked[0] += read
        self.walked[2] += read
        return rem

    def active(self):
        return any(x > 0 for x in self.excess[:self.n + 1])

    def run(self, max_supersteps, relabel_every=25):
        while self.active() and self.step < max_supersteps:
            self.global_relabel()
            budget = min(self.step + relabel_every, max_supersteps)
            while self.active() and self.step < budget:
                self.superstep()
        return self


@pytest.mark.parametrize("cap", [1, 2, 30, 200_000])
@pytest.mark.parametrize("name", SUITE_CASES)
def test_loop_kernel_way_equals_twin(name, cap):
    start, end, valid, capped, n = flow_inputs(*flow_case(name))
    stats = {}
    st, steps, left = twin.push_relabel_run(start, end, valid, capped, n, max_supersteps=cap,
                                            stats=stats)
    C = 7 if name == "small_example" else 256
    emu = Emulated(start, end, valid, capped, n, C, threads=4).run(cap)
    assert emu.f["read"] == st.f_read.tolist()
    assert emu.f["chain"] == st.f_chain.tolist()
    assert emu.f["src"] == st.f_src.tolist()
    assert emu.f["snk"] == st.f_snk.tolist()
    assert emu.excess == st.excess.tolist() and emu.label == st.label.tolist()
    assert emu.step == steps == stats["supersteps"]
    assert sum(x for x in emu.excess[:n + 1] if x > 0) == left
    assert (emu.relabels, emu.rounds) == (stats["global_relabels"], stats["closure_rounds"])


def small_artic(pairs, m):
    """``flow_inputs`` of 4 ARTIC-like amplicons of 180 bases every 130 over
    600 bases, ``pairs`` pairs of 40-60 bases: every primer start and
    amplicon end holds about pairs / 4 reads' arcs."""
    batch = amplicon_pairs(np.random.default_rng(pairs), 600, 4, 10, 130, 180, pairs, 40, 60)
    return flow_inputs(batch, m, 512)


def _equal_to_twin(emu, args, cap):
    start, end, valid, capped, n = args
    stats = {}
    st, steps, left = twin.push_relabel_run(start, end, valid, capped, n, max_supersteps=cap,
                                            stats=stats)
    assert emu.f["read"] == st.f_read.tolist() and emu.f["chain"] == st.f_chain.tolist()
    assert emu.f["src"] == st.f_src.tolist() and emu.f["snk"] == st.f_snk.tolist()
    assert emu.excess == st.excess.tolist() and emu.label == st.label.tolist()
    assert emu.step == steps == stats["supersteps"]
    assert sum(x for x in emu.excess[:n + 1] if x > 0) == left
    assert (emu.relabels, emu.rounds) == (stats["global_relabels"], stats["closure_rounds"])


@pytest.mark.parametrize("case,cap,tile", [
    ("seed0", 30, (4, 2)), ("seed1", 30, (3, 4)), ("artic m=6", 2, (1, 1)),
    ("artic m=30", 30, (4, 2)), ("artic m=6", 200_000, (3, 4)),
    ("artic m=30", 200_000, (1, 1))])
def test_loop_with_cta_walks_equals_twin(case, cap, tile):
    """Segments of 6 arcs or more (the ARTIC cases' primer starts and
    amplicon ends, some nodes of the uniform ones) walked a tile at a
    time; flows, excess, labels, steps and counts equal the twin's."""
    if case.startswith("artic"):
        args = small_artic(80, int(case.split("=")[1]))
    else:
        args = flow_inputs(*flow_case(case))
    emu = Emulated(*args, C=256, threads=4, cta_walk_arcs=6, tile=tile).run(cap)
    _equal_to_twin(emu, args, cap)
    assert emu.walked[2] <= emu.walked[0] + emu.walked[1]
    assert emu.walked[2] > 0 or not case.startswith("artic")


def test_cta_walks_stop_inside_a_tile():
    """At M=6 a primer's excess runs out a few arcs into its 24-arc
    segment: the walk stops inside a tile; the relabels count the same arcs
    as warp walks."""
    args = small_artic(80, 6)
    warp = Emulated(*args, C=256, threads=4).run(200_000)
    cta = Emulated(*args, C=256, threads=4, cta_walk_arcs=6, tile=(4, 4)).run(200_000)
    _equal_to_twin(cta, args, 200_000)
    assert cta.stops_inside > 0 and warp.walked[2] == 0 < cta.walked[2]
    # the relabels read whole segments either way
    assert cta.walked[1] == warp.walked[1]


def test_the_wrapper_mirrors_the_cta_walks_constants():
    text = SOURCE.read_text()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (kThreads|kCtaWalkArcs|kTileItems) = (\d+);", text)}
    assert kernel.CTA_WALK_ARCS == const["kCtaWalkArcs"]
    assert kernel.CTA_TILE == const["kThreads"] * const["kTileItems"]
    assert "constexpr int kTile = kThreads * kTileItems;" in text


def test_flow_solve_on_the_cpu_is_the_twin():
    start, end, valid, capped, n = flow_inputs(*flow_case("seed1"))
    st, left, counts = kernel.flow_solve(start, end, valid, capped, n, max_supersteps=40)
    ref, steps, ref_left = twin.push_relabel_run(start, end, valid, capped, n,
                                                 max_supersteps=40)
    assert all(torch.equal(a, b) for a, b in zip(st, ref))
    assert (left, counts["supersteps"]) == (ref_left, steps)
    assert kernel.flow_solve.launches == 0


def test_flow_solve_raises_on_other_devices():
    start, end, valid, capped, n = (x.to("meta") if torch.is_tensor(x) else x
                                    for x in flow_inputs(*flow_case("small_example")))
    with pytest.raises(ValueError, match="no push-relabel solve for device meta"):
        kernel.flow_solve(start, end, valid, capped, n)


def test_launch_refuses_arguments_the_kernel_does_not_take():
    start, end, valid, capped, n = flow_inputs(*flow_case("small_example"))
    with pytest.raises(ValueError, match="capped: expected"):
        kernel.prepare(start, end, valid, capped[:-1], n, 132)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        kernel.launch(None, {}, 10, 0)


@pytest.mark.parametrize("n,R,G,in_ws", [(11, 32, 1, False), (29_903, 53_248, 117, False),
                                         (29_999, 2_000_000, 118, False),
                                         (900_000, 40_960, 132, True)])
def test_ws_words_matches_the_sources_layout(n, R, G, in_ws):
    """The source states its workspace: kCtrlWords of control, kPartialWords
    a CTA, kWsNodeArrays words a node of n + 3, 8-byte aligned, kTableWords
    a read (two tables of R int2, two flag arrays of R), then, where shared
    memory is short, each CTA's kNodeArrays arrays of C rounded up to 4;
    and the shared memory it leaves the node arrays."""
    text = SOURCE.read_text()
    consts = dict(re.findall(r"\b(kCtrlWords|kPartialWords|kWsNodeArrays|kTableWords) = (\d+)",
                             text))
    ctrl, part, nodes, table = (int(consts[k]) for k in ("kCtrlWords", "kPartialWords",
                                                         "kWsNodeArrays", "kTableWords"))
    assert (ctrl, part, nodes, table) == (kernel._CTRL_WORDS, kernel._PARTIAL_WORDS,
                                          kernel._WS_NODE_ARRAYS, kernel._TABLE_WORDS)
    arrays = int(re.search(r"constexpr int kNodeArrays = (\d+);", text).group(1))
    assert arrays == kernel._KERNEL_NODE_ARRAYS
    shared = int(re.search(r"static_assert\(sizeof\(Shared\) <= (\d+),", text).group(1))
    assert kernel._SMEM_BUDGET == 232_448 - shared
    cap = int(re.search(r"constexpr int kTabCapMax = (\d+);", text).group(1))
    assert cap == kernel._TAB_CAP_MAX
    head = ctrl + part * G + nodes * (n + 3)
    C = -(-(n + 1) // G)
    per_cta = arrays * (-(-C // 4) * 4)
    assert kernel._ws_words(n, R, G, False) == head + head % 2 + table * R
    assert kernel._ws_words(n, R, G, True) == head + head % 2 + table * R + G * per_cta
    # where the arrays go: shared memory while they fit in a CTA's 227 KB
    assert (4 * per_cta > kernel._SMEM_BUDGET) == in_ws
