"""Successive shortest paths over the convex-bucket interval network: the
SSP kernel (``csrc/ssp.cu``) and its plain torch twin.

Counterpart of the device program of the JAX package's
``solvers/device_mcmf.py`` (``_make_phase``: ``chain_closure``,
``bucket_relax``, ``phase``, ``solve_loop``), where the network and the
phase are described. Nodes are the genome positions ``0..n``; chain arcs
``i+1 -> i`` (always residual, zero cost) and ``i -> i+1`` (residual where
the chain carries flow); one arc per bucket ``bstart -> bend + 1`` whose
k-th unit costs ``pool[off0 + k]``. A phase runs a Bellman-Ford fixpoint of
(chain closure, bucket relax) from every node with excess, walks the parent
pointers back from the cheapest deficit node, pushes the largest amount the
path allows and updates the Johnson potentials; phases run until the supply
is 0 or a status other than ``OK`` stops them.

``ssp_solve`` runs the twin on CPU tensors and launches the kernel on CUDA
tensors, or raises; ``ssp_solve.launches`` counts its kernel launches. On
the card ``laps``, if given, receives the kernel's global-timer
nanoseconds in the fixpoint rounds (``rounds_ns``), in each phase's reset
and bucket tables (``tables_ns``) and in the phases' ends (argmin, walk,
push, potentials and supply: ``phase_end_ns``). The
twin reproduces every tie rule of the JAX program (the parents decide the
paths, the paths the flows): scans take the (value, index) minimum with the
smaller index on equal values; updates happen only on strict improvement;
a bucket parent is the smallest bucket id among those reaching the
minimum; the forward bucket side runs before the backward side. int32 sums
wrap, as in XLA. One difference from the JAX program: its walk stops at a
4,096-step buffer, the twin's and the kernel's at n + 2 steps, which a walk
along a parent forest never reaches.
"""

from __future__ import annotations

import torch

from genome_downsampler_tpu_torch.ops import build
from genome_downsampler_tpu_torch.utils.profiling import annotate

INF = 1 << 30
IMAX = 2**31 - 1
PI_GUARD = 1 << 29  # |pi| ceiling keeping all int32 adds safe

# phase status codes
OK = 0
INFEASIBLE = 1
FIXPOINT_CAP = 2
PATH_OVERFLOW = 3
PI_OVERFLOW = 4
DEGENERATE = 5

_STATUS_MSG = {
    INFEASIBLE: "no augmenting path (infeasible network)",
    FIXPOINT_CAP: "distance fixpoint iteration cap hit",
    PATH_OVERFLOW: "augmenting path exceeded its n + 2 step buffer",
    PI_OVERFLOW: "potential magnitude exceeded int32 safety bound",
    DEGENERATE: "degenerate zero-delta augmentation (tie cycle)",
}

# nodes a CTA of the SSP kernel owns at least, unless the SMs run out
# (chosen by measurement: csrc/ssp.cu's note)
CHUNK_FLOOR = 256
# shared memory a CTA may hold on the H100 (227 KB), against the kernel's
# eight int32 node arrays of the chunk; the static part kept aside
_SMEM_BUDGET = 232_448 - 1_024
_KERNEL_NODE_ARRAYS = 8
_KEY = 1 << 32  # (value, index) -> value * 2**32 + index, ordered as a pair
_I32 = torch.int32


def _key(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return v.to(torch.int64) * _KEY + idx


def _split(k: torch.Tensor):
    v = torch.div(k, _KEY, rounding_mode="floor")
    return v.to(_I32), (k - v * _KEY).to(_I32)


def _seg_min_scan(flag: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Inclusive forward min scan of ``key``, restarting where ``flag`` is
    set (log-step doubling over the segmented combine of ``_seg_lexmin``)."""
    f, k = flag.clone(), key.clone()
    o, n = 1, key.shape[0]
    while o < n:
        nk = torch.where(f[o:], k[o:], torch.minimum(k[:-o], k[o:]))
        f = torch.cat([f[:o], f[o:] | f[:-o]])
        k = torch.cat([k[:o], nk])
        o *= 2
    return k


def _chain_closure(d, pk, pid, pi, chainflow):
    n1 = d.shape[0]
    dev = d.device
    idx = torch.arange(n1, dtype=torch.int64, device=dev)
    none = torch.full((1,), INF * _KEY, dtype=torch.int64, device=dev)
    # downward arcs j -> i (j > i): suffix lexmin of d + pi over j > i
    big = torch.where(d >= INF, INF, d + pi)
    suf = torch.flip(torch.cummin(torch.flip(_key(big, idx), [0]), 0).values, [0])
    m1v, m1i = _split(torch.cat([suf[1:], none]))
    cand = torch.where(m1v >= INF, INF, m1v - pi)
    upd = cand < d
    d = torch.where(upd, cand, d)
    pk = torch.where(upd, 1, pk)
    pid = torch.where(upd, m1i, pid)
    # upward arcs u -> v (u < v) where the chain carries flow on [u, v):
    # segmented prefix lexmin, segments broken at zero chain flow
    big = torch.where(d >= INF, INF, d + pi)
    flag = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), chainflow == 0])
    pre = _seg_min_scan(flag, _key(big, idx))
    m1v, m1i = _split(torch.cat([none, pre[:-1]]))
    m1v = torch.where(flag, INF, m1v)
    cand = torch.where(m1v >= INF, INF, m1v - pi)
    upd = cand < d
    d = torch.where(upd, cand, d)
    pk = torch.where(upd, 2, pk)
    pid = torch.where(upd, m1i, pid)
    return d, pk, pid


def _relax_side(d, pk, pid, src, dst, rc, active, kind):
    bidx = torch.arange(src.shape[0], dtype=_I32, device=d.device)
    ds = d[src]
    cand = torch.where(active & (ds < INF), ds + rc, INF)
    d_after = d.scatter_reduce(0, dst, cand, "amin", include_self=True)
    impr = d_after < d
    win = active & (cand == d_after[dst]) & impr[dst]
    stage = torch.full_like(d, IMAX).scatter_reduce(
        0, dst, torch.where(win, bidx, IMAX), "amin", include_self=True
    )
    return d_after, torch.where(impr, kind, pk), torch.where(impr, stage, pid)


def _bucket_relax(d, pk, pid, pi, flow, net):
    bstart, bend1, off0, cap, pool = (net[k] for k in ("bs", "be1", "off0", "cap", "pool"))
    pi_s, pi_t = pi[bstart], pi[bend1]
    # forward: the next unit's marginal cost
    mc_f = pool[(off0 + torch.minimum(flow, cap - 1)).long()]
    d, pk, pid = _relax_side(d, pk, pid, bstart, bend1, mc_f + pi_s - pi_t,
                             flow < cap, 3)
    # backward: refund the last pushed unit
    mc_b = pool[(off0 + torch.clamp(flow - 1, min=0)).long()]
    return _relax_side(d, pk, pid, bend1, bstart, -mc_b + pi_t - pi_s,
                       flow > 0, 4)


def _augment(pk, pid, flow, chainflow, excess, sink, host):
    """Walk the parent pointers from ``sink``, bound the push and apply it.
    Returns ``(flow, chainflow, excess, status)``."""
    n = chainflow.shape[0]
    pkl, pidl, fl = pk.tolist(), pid.tolist(), flow.tolist()
    ex = excess.tolist()
    v, bn = sink, -ex[sink]
    diff = [0] * (n + 1)
    bucket_steps = []
    steps = 0
    while pkl[v] != 0:
        if steps == n + 2:
            return flow, chainflow, excess, PATH_OVERFLOW
        steps += 1
        x, kind = pidl[v], pkl[v]
        if kind == 1:  # down run x -> v: chain arcs [v, x) forward
            diff[v] += 1
            diff[x] -= 1
            v = x
        elif kind == 2:  # up run x -> v: chain arcs [x, v) against the flow
            diff[x] -= 1
            diff[v] += 1
            v = x
        elif kind == 3:
            k = host["off0"][x] + fl[x]
            bn = min(bn, host["run_hi"][k] + 1 - k)
            bucket_steps.append((x, 1))
            v = host["bs"][x]
        else:
            k = host["off0"][x] + fl[x] - 1
            bn = min(bn, host["off0"][x] + fl[x] - host["run_lo"][k])
            bucket_steps.append((x, -1))
            v = host["be1"][x]
    src = v
    coef = torch.cumsum(torch.tensor(diff[:n], dtype=torch.int64), 0).to(_I32)
    coef = coef.to(chainflow.device)
    head = torch.where(
        coef < 0,
        torch.div(chainflow, torch.clamp(-coef, min=1), rounding_mode="floor"),
        IMAX,
    )
    delta = min(bn, int(head.min()), ex[src])
    if delta <= 0:
        return flow, chainflow, excess, DEGENERATE
    for x, sgn in bucket_steps:
        fl[x] += sgn * delta
    excess = excess.clone()
    excess[src] -= delta
    excess[sink] += delta
    return (torch.tensor(fl, dtype=_I32, device=flow.device),
            chainflow + coef * delta, excess, OK)


def _solve_args(bstart, bend1, off0, cap, pool, run_lo, run_hi, excess):
    B, R, n1 = bstart.shape[0], pool.shape[0], excess.shape[0]
    dev = excess.device
    shapes = {"bstart": (bstart, B), "bend1": (bend1, B), "off0": (off0, B),
              "cap": (cap, B), "pool": (pool, R), "run_lo": (run_lo, R),
              "run_hi": (run_hi, R), "excess": (excess, n1)}
    for name, (x, m) in shapes.items():
        if x.dtype != _I32 or tuple(x.shape) != (m,):
            raise ValueError(f"{name}: expected int32[{m}], got {x.dtype}{list(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, excess on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n1 < 2 or B < 1 or R < B:
        raise ValueError(f"need n >= 1, B >= 1 and R >= B; got n={n1 - 1}, B={B}, R={R}")
    return B, n1 - 1


def ssp_solve_plain(bstart, bend1, off0, cap, pool, run_lo, run_hi, excess,
                    phase_cap):
    """Plain torch twin of ``ssp_solve``: the JAX ``solve_loop``, one
    fixpoint round per Python iteration, the walk on host lists."""
    B, n = _solve_args(bstart, bend1, off0, cap, pool, run_lo, run_hi, excess)
    dev = excess.device
    net = {"bs": bstart.long(), "be1": bend1.long(), "off0": off0, "cap": cap,
           "pool": pool}
    host = {"bs": bstart.tolist(), "be1": bend1.tolist(), "off0": off0.tolist(),
            "run_lo": run_lo.tolist(), "run_hi": run_hi.tolist()}
    flow = torch.zeros(B, dtype=_I32, device=dev)
    chainflow = torch.zeros(n, dtype=_I32, device=dev)
    pi = torch.zeros(n + 1, dtype=_I32, device=dev)
    excess = excess.clone()
    it_cap = min(B + 3, 1 << 20)
    supply = int(excess.clamp(min=0).sum(dtype=_I32))
    status, phases, rounds = OK, 0, 0
    while status == OK and supply > 0 and phases < phase_cap:
        d = torch.where(excess > 0, 0, INF).to(_I32)
        pk = torch.zeros(n + 1, dtype=_I32, device=dev)
        pid = torch.zeros(n + 1, dtype=_I32, device=dev)
        changed, it = True, 0
        while changed and it < it_cap:
            d1, pk, pid = _chain_closure(d, pk, pid, pi, chainflow)
            d, pk, pid = _bucket_relax(d1, pk, pid, pi, flow, net)
            changed = bool((d < d1).any())
            it += 1
        rounds += it
        dsel = torch.where(excess < 0, d, INF)
        sink = int(torch.argmin(dsel))
        d_sink = int(dsel[sink])
        pi_new = pi + torch.clamp(d, max=d_sink)
        if d_sink >= INF:
            status = INFEASIBLE
        elif changed:
            status = FIXPOINT_CAP
        else:
            flow, chainflow, excess, status = _augment(
                pk, pid, flow, chainflow, excess, sink, host)
        if status == OK and int(pi_new.max()) > PI_GUARD:
            status = PI_OVERFLOW
        pi = pi_new
        supply = int(excess.clamp(min=0).sum(dtype=_I32))
        phases += 1
    if status == OK and supply > 0:
        status = DEGENERATE
    return flow, supply, status, phases, rounds


def grid_shape(n: int, sms: int):
    """``(G, C)``: the SSP kernel's CTAs for ``n + 1`` nodes on a card of
    ``sms`` SMs, and the nodes a CTA owns (CTA c: ``[c C, c C + C)``)."""
    g = min(sms, -(-(n + 1) // CHUNK_FLOOR))
    return g, -(-(n + 1) // g)


def _ws_words(n: int, B: int, G: int) -> int:
    """int32 words of the kernel's workspace (csrc/ssp.cu: control,
    per-CTA partials, ten node arrays, then two bucket tables of int4)."""
    tables = (16 + 16 * G + 10 * (n + 2) + 3) // 4 * 4
    return tables + 8 * B


def bucket_ranges(bstart, bend1, n: int, G: int, C: int):
    """The buckets each CTA owns: ``[order_f, range_f, sorted_f, order_b,
    range_b, sorted_b]``. The forward side of bucket b is run by the CTA
    that owns ``bend1[b]``, the backward side by the owner of ``bstart[b]``;
    ``order_*`` lists the bucket ids by that node (stable), ``sorted_*`` the
    nodes in that order, and ``range_*[c]:range_*[c + 1]`` is CTA c's share
    of it."""
    bounds = (torch.arange(G + 1, dtype=torch.int64, device=bstart.device) * C).clamp(
        max=n + 1).to(_I32)
    out = []
    for key in (bend1, bstart):
        srt, order = torch.sort(key, stable=True)
        out += [order.to(_I32), torch.searchsorted(srt, bounds).to(_I32), srt]
    return out


def ssp_solve(bstart, bend1, off0, cap, pool, run_lo, run_hi, excess, phase_cap,
              laps=None):
    """Run SSP phases to completion (the SSP kernel: one cooperative launch
    per solve).

    ``bstart``, ``bend1`` (= bucket end + 1), ``off0`` and ``cap`` int32
    ``[B]``; ``pool`` (unit costs, ascending within each bucket),
    ``run_lo``/``run_hi`` (the equal-cost run of each pool entry) int32
    ``[R]``; ``excess`` int32 ``[n + 1]`` the node supplies. Returns
    ``(flow[B] int32 tensor, supply, status, phases, rounds)``, the last four
    Python ints: the supply left, the status code, the phases run and the
    fixpoint rounds over all phases. On the card it raises where the card
    lacks cooperative launch or the grid's CTAs cannot all be resident, and
    fills ``laps`` (a dict), if given, with the kernel's three laps."""
    if excess.device.type == "cpu":
        return ssp_solve_plain(bstart, bend1, off0, cap, pool, run_lo, run_hi,
                               excess, phase_cap)
    if excess.device.type != "cuda":
        raise ValueError(f"no SSP solve for device {excess.device}")
    out = launch(build.load_kernels(), bstart, bend1, off0, cap, pool, run_lo, run_hi,
                 excess, phase_cap, laps)
    ssp_solve.launches += 1
    return out


LAPS = ("rounds_ns", "tables_ns", "phase_end_ns")


def launch(lib, bstart, bend1, off0, cap, pool, run_lo, run_hi, excess, phase_cap,
           laps=None):
    """One launch of ``lib``'s ``gd_ssp_solve`` (the kernel library, or
    another build of the same source) on CUDA tensors, uncounted; returns
    what ``ssp_solve`` returns, and fills ``laps``, if given, with the
    kernel's three laps (``LAPS``). The bucket tables and their one host
    read run in the profiler region ``qmcp.tables``, the launch and the
    read of its scalars in ``qmcp.kernel``."""
    B, n = _solve_args(bstart, bend1, off0, cap, pool, run_lo, run_hi, excess)
    if not 0 <= phase_cap <= IMAX:
        raise ValueError(f"phase_cap {phase_cap} outside int32")
    dev = excess.device
    G, C = grid_shape(n, torch.cuda.get_device_properties(dev).multi_processor_count)
    if _KERNEL_NODE_ARRAYS * 4 * (-(-C // 4) * 4) > _SMEM_BUDGET:
        raise ValueError(f"n={n}: {C} nodes a CTA exceed the SSP kernel's shared memory")
    with annotate("qmcp.tables"):
        order_f, range_f, srt_f, order_b, range_b, srt_b = bucket_ranges(bstart, bend1, n, G,
                                                                          C)
        cap_f, cap_b, lo_f, hi_f, lo_b, hi_b = torch.stack([
            (range_f[1:] - range_f[:-1]).max(), (range_b[1:] - range_b[:-1]).max(),
            srt_f[0], srt_f[-1], srt_b[0], srt_b[-1]]).tolist()
    if not (0 <= lo_f and hi_f <= n and 0 <= lo_b and hi_b <= n):
        raise ValueError(f"bucket nodes outside 0..{n}")
    with annotate("qmcp.kernel"):
        flow = torch.empty(B, dtype=_I32, device=dev)
        # int32[4] (supply, status, phases, rounds), then the int64 laps
        scalars = torch.empty(5, dtype=torch.int64, device=dev)
        ws = torch.empty(_ws_words(n, B, G), dtype=_I32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.gd_ssp_solve(
                bstart.data_ptr(), bend1.data_ptr(), off0.data_ptr(), cap.data_ptr(),
                pool.data_ptr(), run_lo.data_ptr(), run_hi.data_ptr(),
                excess.data_ptr(), order_f.data_ptr(), range_f.data_ptr(),
                order_b.data_ptr(), range_b.data_ptr(), flow.data_ptr(),
                scalars.data_ptr(), ws.data_ptr(),
                n, B, pool.shape[0], G, cap_f, cap_b, int(phase_cap),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        build.check("gd_ssp_solve", rc)
        scalars = scalars.cpu()
    supply, status, phases, rounds = scalars[:2].view(_I32).tolist()
    if laps is not None:
        laps.update(zip(LAPS, scalars[2:].tolist()))
    return flow, supply, status, phases, rounds


ssp_solve.launches = 0
