"""Deterministic data-parallel push-relabel max-flow (``quasi-mcp-flow-cuda``).

Counterpart of the JAX package's ``solvers/push_relabel.py``, where the
flow network, the label-parity waves and the line-scan global relabel are
described. On the card the whole solve is one launch of the push-relabel
kernel (``ops/push_relabel.py::flow_solve``, ``ops/csrc/push_relabel.cu``).
This module's torch program is that kernel's plain twin: it runs on the
device of its inputs (the CPU for ``QuasiMcpPushRelabelSolver("cpu")`` and
the tests, the card where the tests and ``chip_smoke.py`` hold the kernel
to it), and gives the same flows, labels and superstep count as the JAX
program bit for bit. Three places where torch and XLA differ, and what
this module does about each:

- **Out-of-range indices.** The JAX program gathers every kind's flow
  array at every arc's ``slot`` and scatters into every kind's array at
  every slot; XLA clamps the gathers and drops the scatters that fall past
  a shorter array, and the kind masks discard them. torch raises instead.
  So each kind is read and written only over its own arcs: the arc table
  keeps ``flat``, every arc's position in the concatenation of the seven
  kinds' arrays (the order in which the table was assembled, before the
  sort), and the residuals and flow deltas go through that concatenation.
- **int32 wrap.** The JAX superstep's ``cumsum`` of the wanted pushes runs
  in int32 and wraps (chain residuals are about 2**30 each); only the
  within-segment differences are used, and they fit. torch's integer
  ``cumsum`` gives int64, which is kept: the differences come out exact
  and equal to JAX's.
- **Empty segments.** ``segment_min`` gives INT32_MAX to the source, which
  has no out-arcs, and ``+ 1`` then wraps; the eligibility mask hides it.
  Here the minimum starts from ``2 * num_nodes``, the mask stays, and
  nothing depends on the value of an empty segment.

The twin reads every loop condition on the host: one read a round of the
distance closure, and one a block of up to ``relabel_every`` supersteps,
which run without a read because a superstep with no active node changes
nothing and ``step`` advances only while a node is active (a device
counter).
``stats`` counts the reads (``host_syncs``).

Node map: genome positions ``0..n``, source ``S = n+1``, sink ``T = n+2``.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from genome_downsampler_tpu_torch.core.readbatch import ReadBatch
from genome_downsampler_tpu_torch.device import resolve_device
from genome_downsampler_tpu_torch.ops.coverage import (
    capped_coverage,
    coverage_from_intervals,
    demand_from_capped,
)
from genome_downsampler_tpu_torch.solvers.base import Solution, Solver
from genome_downsampler_tpu_torch.utils.profiling import annotate

BIG = 1 << 30  # "infinite" chain capacity and distance, as in the JAX program
_I32 = torch.int32


class ArcTable(NamedTuple):
    """Static residual-arc table, sorted by tail node (stable).

    Arc kinds, in the order the table is assembled (R = padded read count,
    n = genome length):
      0 read_fwd   R     start -> end+1
      1 read_bwd   R     end+1 -> start
      2 chain_fwd  n     i+1 -> i        (always huge residual)
      3 chain_bwd  n     i -> i+1
      4 src_bwd    n+1   i -> S          (residual of S->i)
      5 snk_bwd    n+1   T -> i          (residual of i->T)
      6 snk_fwd    n+1   i -> T
    """

    tails: torch.Tensor  # int32[A] sorted
    heads: torch.Tensor  # int32[A]
    kind: torch.Tensor  # int32[A] (0..6)
    slot: torch.Tensor  # int32[A] index into the kind's flow array
    seg_start: torch.Tensor  # int32[A] first arc index of this tail's segment
    # int64[A]: the arc's index before the sort, which is its kind's offset
    # plus its slot: the seven kinds' arcs are the seven ranges of `flat`
    flat: torch.Tensor


def build_arc_table(start: torch.Tensor, end: torch.Tensor, n: int, R: int) -> ArcTable:
    """Assemble and stably sort the arc table (``start``/``end`` int32[R])."""
    dev = start.device
    S, T = n + 1, n + 2
    i = torch.arange(n, dtype=_I32, device=dev)
    nodes = torch.arange(n + 1, dtype=_I32, device=dev)

    def full(k, v):
        return torch.full((k,), v, dtype=_I32, device=dev)

    tails = torch.cat([start, end + 1, i + 1, i, nodes, full(n + 1, T), nodes])
    heads = torch.cat([end + 1, start, i, i + 1, full(n + 1, S), nodes, full(n + 1, T)])
    sizes = (R, R, n, n, n + 1, n + 1, n + 1)
    kind = torch.cat([full(k, v) for v, k in enumerate(sizes)])
    slot = torch.cat([torch.arange(k, dtype=_I32, device=dev) for k in sizes])

    tails, order = torch.sort(tails, stable=True)
    a_idx = torch.arange(tails.shape[0], dtype=_I32, device=dev)
    is_first = torch.ones_like(tails, dtype=torch.bool)
    is_first[1:] = tails[1:] != tails[:-1]
    seg_start = torch.cummax(torch.where(is_first, a_idx, 0), 0).values
    return ArcTable(tails, heads[order], kind[order], slot[order], seg_start, order)


class FlowState(NamedTuple):
    f_read: torch.Tensor  # int32[R]   flow on read arcs (0/1)
    f_chain: torch.Tensor  # int32[n]   flow on chain arcs i+1->i
    f_src: torch.Tensor  # int32[n+1] flow on S->i
    f_snk: torch.Tensor  # int32[n+1] flow on i->T
    excess: torch.Tensor  # int32[n+3]
    label: torch.Tensor  # int32[n+3]
    step: torch.Tensor  # int32 superstep counter (a 0-d tensor)


def residuals(arcs: ArcTable, st: FlowState, cap_snk: torch.Tensor,
              read_valid: torch.Tensor) -> torch.Tensor:
    """Residual capacity of every arc in the table (int32[A]), each kind's
    array read only at its own arcs' slots."""
    by_kind = torch.cat([
        torch.where(read_valid, 1 - st.f_read, 0),  # read_fwd (padded reads: 0)
        st.f_read,                                  # read_bwd
        BIG - st.f_chain,                           # chain_fwd
        st.f_chain,                                 # chain_bwd
        st.f_src,                                   # src_bwd residual = pushed flow
        st.f_snk,                                   # snk_bwd
        cap_snk - st.f_snk,                         # snk_fwd
    ])
    return by_kind[arcs.flat]


def apply_flow_deltas(st: FlowState, arcs: ArcTable, amt: torch.Tensor):
    """New ``(f_read, f_chain, f_src, f_snk)`` after pushing ``amt`` (int32,
    one per arc) along every arc, each kind's array written only at its own
    arcs' slots."""
    R, n = st.f_read.shape[0], st.f_chain.shape[0]
    d = torch.empty_like(amt)
    d[arcs.flat] = amt  # back to assembly order: kind k is one range
    o = np.cumsum((0, R, R, n, n, n + 1, n + 1, n + 1)).tolist()
    part = [d[o[k]:o[k + 1]] for k in range(7)]
    return (st.f_read + part[0] - part[1],
            st.f_chain + part[2] - part[3],
            st.f_src - part[4],
            st.f_snk - part[5] + part[6])


def _i32_where(cond, a, b):
    return torch.where(cond, a, b).to(_I32)


def dist_closure(d, start, end1, rf, rb, f_chain):
    """Fixpoint of the min-plus relaxation over the residual line and the
    read arcs (the JAX ``_dist_closure``): ``d`` int32[n+1] seeds the
    distance to a target; returns ``(d, rounds)``. The downward chain arcs
    close in one prefix ``cummin`` of ``d(j) - j``; the upward arcs, residual
    within runs of positive chain flow, in one segmented suffix-min of
    ``d(j) + j``: reversed, every run gets the key offset ``-run * 2**31``
    so that a plain ``cummin`` never lets an earlier run win (every value
    lies in ``[0, 2**31)``). Each round is one host read."""
    dev = d.device
    idx = torch.arange(d.shape[0], dtype=_I32, device=dev)
    flags_rev = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           (f_chain == 0).flip(0)])
    seg = torch.cumsum(flags_rev, 0) << 31  # int64
    start, end1 = start.long(), end1.long()

    def closure(d):
        # downward: d(i) <= min_{j<=i} d(j) + (i - j)
        a = _i32_where(d >= BIG, BIG, d - idx)
        pm = torch.cummin(a, 0).values
        d = torch.minimum(d, _i32_where(pm >= BIG, BIG, pm + idx))
        # upward within positive-chain-flow runs: d(i) <= min_{j>=i} d(j) + (j - i)
        e_rev = _i32_where(d >= BIG, BIG, d + idx).flip(0)
        sm = torch.cummin(e_rev - seg, 0).values + seg
        cand = _i32_where(sm >= BIG, BIG, sm).flip(0) - idx
        return torch.minimum(d, cand)

    def hops(d):
        # read arcs, both residual directions, one hop each
        de = d[end1]
        d = d.scatter_reduce(0, start, _i32_where(rf & (de < BIG), de + 1, BIG), "amin")
        ds = d[start]
        return d.scatter_reduce(0, end1, _i32_where(rb & (ds < BIG), ds + 1, BIG), "amin")

    d = closure(d)
    rounds = 0
    while True:
        d0, d = d, hops(closure(d))
        rounds += 1
        if not bool((d < d0).any()):
            return d, rounds


def preflow(capped: torch.Tensor, n: int, R: int):
    """``(cap_src, cap_snk, state)``: the source and sink capacities of the
    line nodes (int32[n+1]) from the per-base target ``capped``, and the
    preflow (every source arc saturated, labels 0 but S's n+3)."""
    dev = capped.device
    num_nodes = n + 3
    demand = demand_from_capped(capped.to(_I32))  # int32[n+1] over nodes 0..n
    cap_src = demand.neg().clamp(min=0)
    cap_snk = demand.clamp(min=0)
    excess = torch.zeros(num_nodes, dtype=_I32, device=dev)
    excess[:n + 1] += cap_src
    excess[n + 1] = -cap_src.sum().to(_I32)
    label = torch.zeros(num_nodes, dtype=_I32, device=dev)
    label[n + 1] = num_nodes
    st = FlowState(
        f_read=torch.zeros(R, dtype=_I32, device=dev),
        f_chain=torch.zeros(n, dtype=_I32, device=dev),
        f_src=cap_src,
        f_snk=torch.zeros(n + 1, dtype=_I32, device=dev),
        excess=excess,
        label=label,
        step=torch.zeros((), dtype=_I32, device=dev),
    )
    return cap_src, cap_snk, st


def push_relabel_solve(
    start: torch.Tensor,
    end: torch.Tensor,
    read_valid: torch.Tensor,
    capped: torch.Tensor,
    n: int,
    max_supersteps: int = 200_000,
    relabel_every: int = 25,
    stats: dict | None = None,
):
    """Push-relabel to a full feasible flow, on the device of ``start``;
    returns ``(selected, steps, excess_left)``: bool[R], and two ints.

    ``capped`` is the per-base selection target ``min(cov, M)`` (int32[n]).
    Selected reads are those whose unit arc carries flow. ``stats``, if
    given, receives ``supersteps``, ``global_relabels``, ``closure_rounds``,
    ``bodies`` (superstep bodies run, those after the last active node
    included), ``host_syncs`` and the laps ``laps_s`` (``arcs``,
    ``relabel``, ``supersteps``; seconds of wall time, each ending in a
    host read)."""
    st, step, excess_left = push_relabel_run(start, end, read_valid, capped, n,
                                             max_supersteps, relabel_every, stats)
    return (st.f_read > 0) & read_valid, step, excess_left


def push_relabel_run(
    start: torch.Tensor,
    end: torch.Tensor,
    read_valid: torch.Tensor,
    capped: torch.Tensor,
    n: int,
    max_supersteps: int = 200_000,
    relabel_every: int = 25,
    stats: dict | None = None,
):
    """``push_relabel_solve``'s program, returning ``(state, steps,
    excess_left)``: the final ``FlowState`` and two ints. The plain twin of
    the push-relabel kernel (``ops/push_relabel.py::flow_solve``)."""
    dev = start.device
    R = start.shape[0]
    num_nodes = n + 3
    t0 = time.perf_counter()
    with annotate("flow.arcs"):
        start32 = start.to(_I32)
        end1 = end.to(_I32) + 1
        arcs = build_arc_table(start32, end.to(_I32), n, R)
        tails, heads, seg_start = arcs.tails.long(), arcs.heads.long(), arcs.seg_start.long()
        # Preflow: saturate all source arcs.
        cap_src, cap_snk, st = preflow(capped, n, R)
        node_is_line = torch.arange(num_nodes, device=dev) <= n
        label_tail = torch.tensor([num_nodes, 0], dtype=_I32, device=dev)  # S, T
    laps = {"arcs": time.perf_counter() - t0, "relabel": 0.0, "supersteps": 0.0}
    count = {"global_relabels": 0, "closure_rounds": 0, "bodies": 0, "host_syncs": 0}

    def active_mask(st):
        # T absorbs; S re-absorbs returned flow. Line nodes with excess push.
        return node_is_line & (st.excess > 0)

    def global_relabel(st):
        """Exact residual distances via line scans (two closures)."""
        rf = read_valid & (st.f_read == 0)
        rb = read_valid & (st.f_read > 0)
        # distance to T: seed 1 where the i -> T arc has residual
        dT, r1 = dist_closure(_i32_where(cap_snk - st.f_snk > 0, 1, BIG),
                              start32, end1, rf, rb, st.f_chain)
        # nodes cut off from T route excess back to S (label n+3 + dist)
        dS, r2 = dist_closure(_i32_where(st.f_src > 0, 1, BIG),
                              start32, end1, rf, rb, st.f_chain)
        count["global_relabels"] += 1
        count["closure_rounds"] += r1 + r2
        count["host_syncs"] += r1 + r2
        lab_line = _i32_where(dT < BIG, dT, _i32_where(dS < BIG, num_nodes + dS, 2 * num_nodes))
        return st._replace(label=torch.cat([lab_line, label_tail]))

    def superstep(st):
        active = active_mask(st)
        lab_t = st.label[tails]
        lab_h = st.label[heads]
        res = residuals(arcs, st, cap_snk, read_valid)

        elig_node = active & ((st.label & 1) == st.step % 2)
        admissible = elig_node[tails] & (res > 0) & (lab_t == lab_h + 1)
        want = torch.where(admissible, res, 0)

        # Segmented exclusive prefix of `want` within each tail's arc run
        # (int64: the running sum passes 2**31): each node pushes on its
        # admissible arcs in table order until its excess is spent.
        excl = torch.cumsum(want, 0) - want
        within = excl - excl[seg_start]
        ex_t = st.excess[tails]
        amt = torch.minimum((ex_t - within).clamp(min=0), want).to(_I32)

        f_read, f_chain, f_src, f_snk = apply_flow_deltas(st, arcs, amt)
        pushed_out = torch.zeros(num_nodes, dtype=_I32, device=dev).index_add_(0, tails, amt)
        pushed_in = torch.zeros(num_nodes, dtype=_I32, device=dev).index_add_(0, heads, amt)
        excess = st.excess - pushed_out + pushed_in

        # Relabel eligible nodes that pushed nothing: rise to 1 + min label
        # over post-wave residual arcs (an incoming cancellation creates a
        # residual arc whose head label bounds the legal rise).
        st_post = FlowState(f_read, f_chain, f_src, f_snk, excess, st.label, st.step)
        res_post = residuals(arcs, st_post, cap_snk, read_valid)
        cap = 2 * num_nodes
        out_min = torch.full((num_nodes,), cap, dtype=_I32, device=dev).scatter_reduce_(
            0, tails, _i32_where(res_post > 0, lab_h, cap), "amin")
        new_label = (out_min + 1).clamp(max=cap)
        do_relabel = elig_node & (pushed_out == 0) & (excess > 0)
        label = torch.where(do_relabel, new_label, st.label)
        # a superstep with no active node is a no-op: only then step stays
        step = st.step + active.any().to(_I32)
        return FlowState(f_read, f_chain, f_src, f_snk, excess, label, step)

    def flags(st):
        """(any node active, step): one host read."""
        count["host_syncs"] += 1
        live, step = torch.stack([active_mask(st).any().to(_I32), st.step]).tolist()
        return bool(live), step

    live, step = flags(st)
    while live and step < max_supersteps:
        t0 = time.perf_counter()
        with annotate("flow.relabel"):
            st = global_relabel(st)
        t1 = time.perf_counter()
        # up to `relabel_every` waves, read once at the end
        with annotate("flow.supersteps"):
            for _ in range(min(step + relabel_every, max_supersteps) - step):
                st = superstep(st)
                count["bodies"] += 1
            live, step = flags(st)
        t2 = time.perf_counter()
        laps["relabel"] += t1 - t0
        laps["supersteps"] += t2 - t1
    excess_left = int(torch.where(active_mask(st), st.excess, 0).sum())
    count["host_syncs"] += 1
    if stats is not None:
        stats.update(supersteps=step, laps_s=laps, **count)
    return st, step, excess_left


class QuasiMcpPushRelabelSolver(Solver):
    """Feasible-selection push-relabel solver (``quasi-mcp-flow-cuda``),
    deterministic and bit-equal to the JAX ``quasi-mcp-flow-tpu``.

    ``device`` is required: ``"cuda"`` runs the solve as one launch of the
    push-relabel kernel (and raises without a card, or where the kernel
    does not build or launch), ``"cpu"`` runs the torch program on the host
    (the tests). ``last_stats`` holds ``engine`` (``"cuda"`` or
    ``"torch"``), the counts ``supersteps``, ``bodies``,
    ``global_relabels``, ``closure_rounds``, ``host_syncs`` and the laps
    ``laps_s`` (seconds): on the CPU ``coverage``, ``arcs``, ``relabel``,
    ``supersteps`` and ``select``; on the card ``coverage``, ``arcs`` (the
    host's time to queue the tables and the preflow), ``kernel`` (from the
    launch to its one read) and ``select``, beside the kernel's own counts
    (``ops/push_relabel.py::flow_solve``: CTA 0's global-timer
    ``closure_ns`` and ``superstep_ns`` and clock64 cycles, and the arcs
    its walks read). On the card ``bodies`` equals ``supersteps`` (the
    kernel runs no no-op body)."""

    uses_quality_of_reads = False

    def __init__(
        self,
        device: str | torch.device,
        pad_multiple: int = 4096,
        max_supersteps: int = 200_000,
        relabel_every: int = 25,
    ):
        self.device = resolve_device(device)
        self.pad_multiple = pad_multiple
        self.max_supersteps = max_supersteps
        self.relabel_every = relabel_every
        self.last_stats: dict | None = None

    def solve(self, max_coverage: int, batch: ReadBatch) -> Solution:
        n = batch.ref_genome_length
        on_card = self.device.type == "cuda"
        stats = {"engine": "cuda" if on_card else "torch", "device": str(self.device)}
        self.last_stats = stats
        t0 = time.perf_counter()
        with annotate("flow.coverage"):
            arrays, valid = batch.padded(self.pad_multiple)
            start = torch.tensor(arrays["start"], device=self.device)
            end = torch.tensor(arrays["end"], device=self.device)
            vmask = torch.tensor(valid, device=self.device)
            cov = coverage_from_intervals(start, end, n, vmask.to(_I32))
            capped = capped_coverage(cov, int(max_coverage))
        t_cov = time.perf_counter() - t0
        if on_card:
            from genome_downsampler_tpu_torch.ops.push_relabel import flow_solve

            st, excess_left, counts = flow_solve(
                start, end, vmask, capped, n, max_supersteps=self.max_supersteps,
                relabel_every=self.relabel_every)
            stats.update(counts)
            selected = (st.f_read > 0) & vmask
        else:
            selected, _, excess_left = push_relabel_solve(
                start, end, vmask, capped, n,
                max_supersteps=self.max_supersteps,
                relabel_every=self.relabel_every,
                stats=stats,
            )
        if excess_left != 0:
            raise RuntimeError(
                f"push-relabel did not converge: {excess_left} excess "
                f"left after {stats['supersteps']} supersteps "
                f"(cap {self.max_supersteps}); selection would be infeasible"
            )
        t0 = time.perf_counter()
        with annotate("flow.select"):
            sel = np.flatnonzero(selected.cpu().numpy()).astype(np.int64)
        stats["laps_s"] = {"coverage": t_cov, **stats["laps_s"],
                           "select": time.perf_counter() - t0}
        return sel
