"""Push-relabel max-flow over the interval network: the push-relabel kernel
(``csrc/push_relabel.cu``), which runs ``quasi-mcp-flow-cuda``'s whole solve
in one cooperative launch, and its wrapper.

Counterpart of two device programs of the JAX package's
``solvers/push_relabel.py``: the distance closure ``_dist_closure`` (run
twice by each global relabel) and the superstep ``body``, with the loop
around them. The plain twin is the torch program of the port's
``solvers/push_relabel.py`` (``push_relabel_run``), which the kernel equals
bit for bit in the final flows, excess, labels and step, and in the counts
of global relabels and closure rounds.

The design (the source's note has the details). One grid of
G = min(SMs, ceil((n + 1) / 256)) CTAs (``ops/ssp.py::grid_shape``); CTA c
owns the line nodes ``[c C, (c + 1) C)`` in shared memory (above about
840,000 nodes on 132 SMs a CTA's node arrays lie in the workspace instead).
A closure round is two grid barriers. Before the first, each CTA scans its
chunk with no carry (the prefix-min of ``d(j) - j`` and the reverse scan
of ``d(j) + j`` segmented at zero chain flow) and publishes one record
and three words a node; after it, every CTA folds all G records into every
chunk's carries, closes its chunk and runs the forward hop, reading the
post-closure d of other chunks' nodes from their words. The second barrier
is the snapshot the backward hop reads. Each hop is owned by the CTA of
its tail and reads a table of distinct arcs: one entry a ``(tail, other
end)`` group of valid reads with a residual member, compacted at each
global relabel into shared memory where the CTA's groups fit. A superstep
is two barriers: a warp walks each eligible node's segment of the
tail-sorted arc table (the whole CTA where the segment holds
``CTA_WALK_ARCS`` arcs or more) and pushes ``min(remaining,
want)`` in table order, what reaches a head is added to it atomically;
then each owner updates its excess and relabels into a second label
buffer. The host reads once a solve: the scalars at the end.

What bounds it: the barriers a round must pass and the L2 round trips of
the hops' gathers, not the bytes (about 8 a node and 10 a distinct read
arc a round, 28 an arc a superstep) nor the operations. The rounds
themselves belong to the algorithm (12,299 at config-1), so even at its
bound a solve stays far above the host greedy's time.

``flow_solve`` launches the kernel on CUDA tensors (counted in
``flow_solve.launches``), runs the twin on CPU tensors, and raises on any
other device. The wrapper builds the kernel's static tables with torch ops:
the arc table without the padded reads' arcs (never residual, so never
pushed on nor counted in a relabel) and each line node's first arc, and
for each hop direction the valid reads sorted by ``(tail, other end)``
with their groups and each CTA's share of both.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from genome_downsampler_tpu_torch.ops import build
from genome_downsampler_tpu_torch.ops.ssp import grid_shape
from genome_downsampler_tpu_torch.solvers.push_relabel import (
    FlowState,
    build_arc_table,
    preflow,
    push_relabel_run,
)
from genome_downsampler_tpu_torch.utils.profiling import annotate

BIG = 1 << 30
_I32 = torch.int32
# int32 arrays of C entries a CTA holds (csrc/push_relabel.cu:
# kNodeArrays), in shared memory while they fit in the 227 KB a CTA may
# hold on the H100 beside the kernel's static 4 KB (its Shared)
_KERNEL_NODE_ARRAYS = 9
_SMEM_BUDGET = 232_448 - 4_096
# a direction's compacted hop entries a CTA holds in shared memory at most
# (csrc/push_relabel.cu: kTabCapMax); a CTA with more groups keeps its
# tables in the workspace
_TAB_CAP_MAX = 4096
# the workspace's layout (csrc/push_relabel.cu: kCtrlWords, kPartialWords,
# kWsNodeArrays, kTableWords)
_CTRL_WORDS, _PARTIAL_WORDS, _WS_NODE_ARRAYS, _TABLE_WORDS = 16, 12, 7, 6
# a segment of this many arcs or more is walked by its CTA, CTA_TILE arcs
# a step (csrc/push_relabel.cu: kCtaWalkArcs, kTile)
CTA_WALK_ARCS, CTA_TILE = 256, 1024
# the kernel's int64 scalars, in order (the C entry's note)
SCALARS = ("supersteps", "excess_left", "global_relabels", "closure_rounds", "closure_ns",
           "superstep_ns", "closure_cycles", "superstep_cycles", "arcs_discharged",
           "arcs_relabelled", "arcs_cta_walked")


def _node_words(n: int, G: int) -> int:
    """int32 words of one CTA's node arrays (csrc/push_relabel.cu: Cp)."""
    return _KERNEL_NODE_ARRAYS * ((-(-(n + 1) // G) + 3) // 4 * 4)


def _ws_words(n: int, R: int, G: int, nodes_in_ws: bool) -> int:
    """int32 words of the kernel's workspace: control, per-CTA partials,
    seven words a node of n + 3, 8-byte aligned, then six a read (two
    tables of R int2, two flag arrays of R), then, with ``nodes_in_ws``,
    every CTA's node arrays."""
    head = _CTRL_WORDS + _PARTIAL_WORDS * G + _WS_NODE_ARRAYS * (n + 3)
    return ((head + 1) // 2 * 2 + _TABLE_WORDS * R
            + (G * _node_words(n, G) if nodes_in_ws else 0))


def kernel_arc_table(start: torch.Tensor, end: torch.Tensor, read_valid: torch.Tensor,
                     n: int):
    """``(arcs, off)``: the kernel's tail-sorted arc table, int32[A, 2]
    rows ``(head, slot << 3 | kind)``, and int32[n + 2] each line node's
    first arc (``off[n + 1]`` ends node n's segment). The twin's table
    (``build_arc_table``, the same stable order) with the padded reads'
    arcs moved to node n + 3, past every segment."""
    past = n + 3
    arcs = build_arc_table(torch.where(read_valid, start, past),
                           torch.where(read_valid, end, past - 1), n, start.shape[0])
    table = torch.stack([arcs.heads, (arcs.slot << 3) | arcs.kind], 1).contiguous()
    nodes = torch.arange(n + 2, dtype=_I32, device=start.device)
    return table, torch.searchsorted(arcs.tails, nodes).to(_I32)


class HopTable(NamedTuple):
    """One hop direction's tables: the reads of each ``(tail, other end)``
    group and the groups, each with every CTA's share."""

    members: torch.Tensor  # int32[R, 2] (read, group), sorted by (tail, other end, read)
    range: torch.Tensor  # int32[G + 1]: CTA c's valid members [range[c], range[c + 1])
    groups: torch.Tensor  # int32[R, 2] (tail, other end) of group g at row g
    grange: torch.Tensor  # int32[G + 1]: CTA c's groups [grange[c], grange[c + 1])


def hop_tables(start: torch.Tensor, end1: torch.Tensor, read_valid: torch.Tensor, n: int,
               G: int, C: int):
    """``(forward, backward)``: the ``HopTable`` of the reads by ``(start,
    end + 1)`` and by ``(end + 1, start)``. Groups are numbered in key
    order, so CTA c's (those whose tail lies in ``[c C, c C + C)``) are
    contiguous, as are its members. Padded reads, and the rows past the
    last group (tail ``n + 1``), lie past every share. Torch ops on the
    device of ``start``, no host read."""
    dev = start.device
    R = start.shape[0]
    reads = torch.arange(R, dtype=_I32, device=dev)
    bounds = (torch.arange(G + 1, dtype=torch.int64, device=dev) * C).clamp(
        max=n + 1).to(_I32)
    width = n + 2
    pad = (n + 1) * width
    out = []
    for tail, other in ((start, end1), (end1, start)):
        key = torch.where(read_valid, tail.long() * width + other.long(), pad)
        key, order = torch.sort(key, stable=True)
        first = torch.ones(R, dtype=torch.bool, device=dev)
        first[1:] = key[1:] != key[:-1]
        gid = (torch.cumsum(first, 0) - 1).to(_I32)
        gkey = torch.full((R,), pad, dtype=torch.int64, device=dev).scatter_reduce(
            0, gid.long(), key, "amin", include_self=False)
        gtail = (gkey // width).to(_I32)
        out.append(HopTable(
            torch.stack([reads[order], gid], 1).contiguous(),
            torch.searchsorted((key // width).to(_I32), bounds).to(_I32),
            torch.stack([gtail, (gkey % width).to(_I32)], 1).contiguous(),
            torch.searchsorted(gtail, bounds).to(_I32)))
    return tuple(out)


def _solve_args(start, end, read_valid, capped, n):
    R = start.shape[0]
    dev = start.device
    for name, x, dtype, m in (("start", start, _I32, R), ("end", end, _I32, R),
                              ("read_valid", read_valid, torch.bool, R),
                              ("capped", capped, _I32, n)):
        if x.dtype != dtype or tuple(x.shape) != (m,):
            raise ValueError(f"{name}: expected {dtype}[{m}], got {x.dtype}{list(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, start on {dev}")
    if n < 1 or R < 1:
        raise ValueError(f"need n >= 1 and R >= 1; got n={n}, R={R}")
    return R


def prepare(start, end, read_valid, capped, n: int, sms: int) -> dict:
    """The kernel's inputs (torch ops on the device of ``start``, no host
    read): the tables, the capacities and the preflow of the twin
    (``solvers/push_relabel.py::preflow``), and the grid."""
    R = _solve_args(start, end, read_valid, capped, n)
    G, C = grid_shape(n, sms)
    arcs, off = kernel_arc_table(start, end, read_valid, n)
    fwd, bwd = hop_tables(start, end + 1, read_valid, n, G, C)
    cap_src, cap_snk, st = preflow(capped, n, R)
    return {"arcs": arcs, "off": off, "hop_f": fwd, "hop_b": bwd,
            "cap_src": cap_src, "cap_snk": cap_snk,
            "excess0": st.excess, "label0": st.label, "n": n, "R": R, "G": G,
            # a CTA's node arrays in the workspace where shared memory is short
            "nodes_in_ws": 4 * _node_words(n, G) > _SMEM_BUDGET}


def launch(lib, prep: dict, max_supersteps: int, relabel_every: int):
    """One launch of ``lib``'s ``gd_push_relabel_solve`` (the kernel
    library, or another build of the same source) on ``prepare``'s
    tensors, uncounted, with no host read; returns ``(f_read, f_chain,
    f_src, f_snk, excess, label, scalars)``, scalars int64[11] named by
    ``SCALARS`` (step, excess_left, global relabels, closure rounds, CTA
    0's ns and clock64 cycles inside global relabels and inside
    supersteps, the arcs the discharges and the relabels read, then the
    arcs of both that the CTA walks of long segments read)."""
    if not 0 <= max_supersteps < 2**31 or not 1 <= relabel_every < 2**31:
        raise ValueError(f"max_supersteps {max_supersteps} or relabel_every "
                         f"{relabel_every} outside the kernel's range")
    n, R, G = prep["n"], prep["R"], prep["G"]
    dev = prep["arcs"].device
    out = [torch.empty(m, dtype=_I32, device=dev) for m in (R, n, n + 1, n + 1, n + 3, n + 3)]
    scalars = torch.empty(len(SCALARS), dtype=torch.int64, device=dev)
    ws = torch.empty(_ws_words(n, R, G, prep["nodes_in_ws"]), dtype=_I32, device=dev)
    ins = [prep["arcs"], prep["off"], *prep["hop_f"], *prep["hop_b"],
           *(prep[k] for k in ("cap_src", "cap_snk", "excess0", "label0"))]
    with torch.cuda.device(dev):
        rc = lib.gd_push_relabel_solve(
            *(x.data_ptr() for x in (*ins, *out, scalars, ws)),
            n, R, G, int(max_supersteps), int(relabel_every), int(prep["nodes_in_ws"]),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check("gd_push_relabel_solve", rc)
    return (*out, scalars)


def kernel_counts(scalars: list) -> dict:
    """The kernel's scalars (``launch``'s, read to the host) as
    ``flow_solve``'s counts: each under its ``SCALARS`` name but the excess
    left, with ``bodies`` (the kernel runs no no-op body) and one host
    read."""
    if len(scalars) != len(SCALARS):
        raise ValueError(f"{len(scalars)} scalars; the kernel returns {len(SCALARS)}")
    counts = dict(zip(SCALARS, scalars))
    del counts["excess_left"]
    return {**counts, "bodies": counts["supersteps"], "host_syncs": 1}


def flow_solve(start, end, read_valid, capped, n: int, max_supersteps: int = 200_000,
               relabel_every: int = 25):
    """Push-relabel to a full feasible flow: ``(state, excess_left,
    counts)``, the final ``FlowState`` (``solvers/push_relabel.py``), the
    excess left on active line nodes and ``supersteps``, ``bodies``,
    ``global_relabels``, ``closure_rounds``, ``host_syncs`` and ``laps_s``.

    ``start``, ``end`` int32[R] (padded reads ``0, -1``), ``read_valid``
    bool[R], ``capped`` int32[n] the per-base target. On CUDA tensors one
    kernel launch and one host read (the counts also give the kernel's
    ``closure_ns``, ``superstep_ns``, ``closure_cycles``,
    ``superstep_cycles``, and the arcs its walks read, ``arcs_discharged``
    and ``arcs_relabelled``, of which ``arcs_cta_walked`` by the CTA walks
    of long segments; a discharge counts the arcs up to the end of the step
    where its excess ran out, 32 a warp step or ``CTA_TILE`` a CTA step, so
    ``arcs_discharged`` depends on the walks' widths; ``laps_s`` has the
    host's ``arcs``, the time
    to queue the tables and the preflow, and ``kernel``, from the launch
    to its read), inside the profiler regions ``flow.prepare`` and
    ``flow.kernel``; on CPU tensors the twin."""
    dev = start.device
    if dev.type == "cpu":
        counts = {}
        st, _, excess_left = push_relabel_run(start, end, read_valid, capped, n,
                                              max_supersteps, relabel_every, counts)
        return st, excess_left, counts
    if dev.type != "cuda":
        raise ValueError(f"no push-relabel solve for device {dev}")
    t0 = time.perf_counter()
    with annotate("flow.prepare"):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        prep = prepare(start, end, read_valid, capped, n, sms)
    t1 = time.perf_counter()
    with annotate("flow.kernel"):
        *state, scalars = launch(build.load_kernels(), prep, max_supersteps, relabel_every)
        flow_solve.launches += 1
        values = scalars.tolist()
    t2 = time.perf_counter()
    st = FlowState(*state, step=scalars[0].to(_I32))
    counts = {**kernel_counts(values), "laps_s": {"arcs": t1 - t0, "kernel": t2 - t1}}
    return st, values[SCALARS.index("excess_left")], counts


flow_solve.launches = 0
