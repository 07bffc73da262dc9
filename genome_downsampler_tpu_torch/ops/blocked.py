"""Blocked multi-window exact sweep and selection pass: the device half of
the large-genome solver.

Counterpart of the device half of the JAX package's
``ops/pallas_blocked.py`` (the design is described there). Reads are
bucketed on the host into ``(block t, window w)`` groups of codes
``start_rel * L + span - 1`` (``_native.pack_flat_direct``); on the device:

- ``expand_flat_codes`` rebuilds the padded ``(nbw, W, cap)`` int32 layout
  (``-1`` pads) from the flat uint16 stream;
- ``blocked_sweep_pass`` (kernel B, ``csrc/blocked_sweep.cu``; for long
  reads or deep stacks its wide path ``csrc/blocked_sweep_wide.cu``) runs
  one relaxation round of the water-filling sweep over all W windows;
- ``blocked_windowed_sweep`` drives rounds until every window's carry-in
  equals its left neighbour's carry-out, which makes the result
  bit-identical to the global sequential sweep;
- ``blocked_selection_pass`` (kernel C, ``csrc/blocked_select.cu``) turns
  the per-end selected counts into one selection byte per packed slot.

Each kernel has a plain torch twin here (``*_plain``) with the same
arguments and results. A wrapper given CPU tensors runs the twin; given
CUDA tensors it launches the kernel or raises. ``launches`` on each
wrapper counts its kernel launches.

Carries are int32 ``(W, L)`` in avail form: ``avail[k]`` unselected and
``selend[k]`` selected reads covering the position whose end is ``k``
positions ahead, ``availi[k]`` the same ring without takes (the input
coverage, under ``auto_target``).
"""

from __future__ import annotations

import torch

from genome_downsampler_tpu_torch.ops import build

# largest block the CUDA sweep kernel takes; the L values of its register
# path (csrc/blocked_sweep.cu) and the most reads of one window that may
# start at one position there (its arrival counts are uint16); every other
# L, a multiple of 32, and deeper stacks take the wide path
# (csrc/blocked_sweep_wide.cu: per-end counts and a set of the live ends,
# in shared memory or, past it, a global workspace; see wide_tier). Kernels
# B and C take any L with B * L below _CUDA_MAX_CODES: the codes start_rel *
# L + span - 1 are int32.
_CUDA_MAX_BLOCK = 256
_CUDA_SPANS = (32, 64, 128, 256, 384, 512, 640, 768)
_CUDA_MAX_CODES = 1 << 31
_CUDA_MAX_STARTS = 65535

# the wide path's tiers (csrc/blocked_sweep_wide.cu, whose layout
# wide_layout mirrors): the most shared memory a CTA may have on sm_90, the
# largest L of tier 0's flat mask, and the offsets, targets and outputs it
# stages (ints); kernel C's warps (csrc/blocked_select.cu: its tile holds
# (1 + warps) (B + L) ints in the same shared memory)
_WIDE_MAX_SMEM = 232448
_WIDE_MASK_SPAN = 4096
_WIDE_STAGING = 6 * _CUDA_MAX_BLOCK + 2
_SELECT_WARPS = 4


def _check_cuda_span(what: str, B: int, L: int) -> None:
    if L < 32 or L % 32 or B * L >= _CUDA_MAX_CODES:
        raise ValueError(
            f"CUDA {what} kernel supports max_span a multiple of 32 with "
            f"block * max_span < 2^31 (the blocked engine's int32 codes); got "
            f"max_span={L}, block={B}"
        )


def tree_words(L: int) -> int:
    """Words of the wide path's live-end tree at ``L``: the mask (L/32
    words), then a level of one bit a word of the level below, up to a
    level of one word."""
    n = total = L // 32
    while n > 1:
        n = -(-n // 32)
        total += n
    return total


def wide_layout(tier: int, B: int, L: int, auto_target: bool) -> tuple[int, int]:
    """``(shared bytes, workspace int32 words a window)`` of the wide path's
    tier ``tier`` at ``(B, L)``: 0 all in shared memory with a flat mask, 1
    the same with the live-end tree, 2 the counts and the availi ring in
    the workspace, 3 the tree there too."""
    R = 0
    if auto_target:
        R = 1
        while R < B + L + 1:
            R <<= 1
    T = tree_words(L)
    return [(4 * (2 * L + L // 32 + _WIDE_STAGING + R), 0),
            (4 * (2 * L + T + _WIDE_STAGING + R), 0),
            (4 * (T + _WIDE_STAGING), 2 * L + R),
            (4 * _WIDE_STAGING, 2 * L + R + T)][tier]


def wide_tier(B: int, L: int, auto_target: bool, tier: int | None = None
              ) -> tuple[int, int, int]:
    """``(tier, shared bytes, workspace int32 words a window)`` the wide
    path runs at ``(B, L)``: tier 0 up to L = 4,096, above it the least of
    tiers 1-3 whose shared memory fits, or ``tier``, which may be any higher
    one (to time one tier against another at one L)."""
    least = 0 if L <= _WIDE_MASK_SPAN else next(
        t for t in (1, 2, 3) if wide_layout(t, B, L, auto_target)[0] <= _WIDE_MAX_SMEM)
    if tier is None:
        tier = least
    elif not least <= tier <= (3 if least else 0):
        runs = f"tiers {least}-3" if least else "tier 0"
        raise ValueError(f"the wide path runs {runs} at block={B}, max_span={L}; "
                         f"got tier={tier}")
    return (tier, *wide_layout(tier, B, L, auto_target))


def select_path(B: int, L: int, path: str | None = None) -> str:
    """Kernel C's path at ``(B, L)``: ``"tile"`` while its (1 + warps) (B +
    L)-int tile fits shared memory, else ``"hash"``; or ``path``, where
    ``"hash"`` runs at any L (to time the two at one L)."""
    fits = 4 * (1 + _SELECT_WARPS) * (B + L) <= _WIDE_MAX_SMEM
    if path is None:
        return "tile" if fits else "hash"
    if path != "hash" and not (path == "tile" and fits):
        raise ValueError(f"kernel C runs {'tile or hash' if fits else 'hash'} at "
                         f"block={B}, max_span={L}; got path={path!r}")
    return path


def expand_flat_codes(flat: torch.Tensor, counts: torch.Tensor, nbw: int,
                      W: int, cap: int) -> torch.Tensor:
    """Scatter the flat code stream (group order, uint16 bits carried in an
    int16 tensor) into the padded ``(nbw, W, cap)`` int32 layout with
    ``-1`` pads; ``0xFFFF`` also restores to ``-1``."""
    dev = flat.device
    G = nbw * W
    R = flat.shape[0]
    c = counts.reshape(G).to(torch.int64)
    off = torch.cumsum(c, 0) - c
    g = torch.repeat_interleave(
        torch.arange(G, dtype=torch.int64, device=dev), c, output_size=R
    )
    idx = torch.arange(R, dtype=torch.int64, device=dev) - off[g] + g * cap
    codes = flat.to(torch.int32) & 0xFFFF
    codes = torch.where(codes == 0xFFFF, -1, codes)
    full = torch.full((G * cap,), -1, dtype=torch.int32, device=dev)
    full[idx] = codes
    return full.reshape(nbw, W, cap)


def _check_i32(name: str, x: torch.Tensor, shape: tuple, dev: torch.device):
    if x.dtype != torch.int32 or tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected int32{list(shape)}, got {x.dtype}{list(x.shape)}"
        )
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, packed on {dev}")


def _sweep_args(packed, counts, target, avail0, selend0, avail0i, W, B, L,
                grid_offset, auto_target):
    nbw, Wp, cap = packed.shape
    dev = packed.device
    if Wp != W:
        raise ValueError(f"packed has {Wp} windows, n_windows={W}")
    if not 0 <= grid_offset < nbw:
        raise ValueError(f"grid_offset {grid_offset} outside [0, {nbw})")
    _check_i32("packed", packed, (nbw, W, cap), dev)
    _check_i32("counts", counts, (nbw, W), dev)
    _check_i32("avail0", avail0, (W, L), dev)
    _check_i32("selend0", selend0, (W, L), dev)
    if avail0i is None:
        avail0i = torch.zeros((W, L), dtype=torch.int32, device=dev)
    _check_i32("avail0i", avail0i, (W, L), dev)
    if auto_target:
        if target is not None:
            raise ValueError("auto_target derives the target; pass target=None")
    else:
        if target is None:
            raise ValueError("target is required unless auto_target")
        _check_i32("target", target, (W, nbw * B), dev)
    return avail0i


def _arrival_rows(codes: torch.Tensor, B: int, L: int) -> torch.Tensor:
    """``rows[b, w, k]`` = # reads of one block starting at ``b`` with span
    ``k + 1``, from its ``(W, cap)`` codes (``-1`` pads count nothing)."""
    W = codes.shape[0]
    valid = codes >= 0
    c = codes.clamp(min=0).to(torch.int64)
    w_idx = torch.arange(W, device=codes.device)[:, None]
    flat = ((c // L) * W + w_idx) * L + c % L
    rows = torch.zeros(B * W * L, dtype=torch.int32, device=codes.device)
    rows.index_add_(0, flat.reshape(-1), valid.reshape(-1).to(torch.int32))
    return rows.reshape(B, W, L)


def _max_starts(packed: torch.Tensor, B: int, L: int) -> int:
    """The most reads of one ``(block, window)`` group starting at one
    position."""
    codes = packed.reshape(-1, packed.shape[2]).to(torch.int64)
    key = torch.arange(codes.shape[0], device=codes.device)[:, None] * B + codes // L
    return int(torch.bincount(key[codes >= 0]).max()) if bool((codes >= 0).any()) else 0


def _shift(x: torch.Tensor) -> torch.Tensor:
    """Ring slot ``k + 1`` becomes slot ``k``; the top slot empties."""
    return torch.nn.functional.pad(x[:, 1:], (0, 1))


def _avail_step(avail, selend, add, tgt):
    """One avail-form sweep step of every row (``(rows, L)`` rings,
    ``(rows,)`` targets): fold in the arrivals ``add``, take the deficit
    from the farthest end slots first. Returns ``(take, avail, selend)``
    after the take, before the shift."""
    avail = avail + add
    deficit = (tgt - selend.sum(1, dtype=torch.int32)).clamp(min=0)
    above = torch.flip(
        torch.cumsum(torch.flip(avail, [1]), 1, dtype=torch.int32), [1]
    ) - avail
    take = torch.minimum((deficit[:, None] - above).clamp(min=0), avail)
    return take, avail - take, selend + take


def blocked_sweep_pass_plain(
    packed, counts, target, avail0, selend0, n_windows, block, max_span, *,
    grid_offset=0, avail0i=None, auto_target=False, max_coverage=0,
):
    """Plain torch twin of ``blocked_sweep_pass``: the global sweep's
    avail-form step (``solvers.device_sweep.sweep_counts``), all W windows
    at once, one position per Python iteration."""
    W, B, L = n_windows, block, max_span
    avail0i = _sweep_args(packed, counts, target, avail0, selend0, avail0i,
                          W, B, L, grid_offset, auto_target)
    nbw = packed.shape[0]
    avail, selend, availi = avail0.clone(), selend0.clone(), avail0i.clone()
    out = torch.empty((W, (nbw - grid_offset) * B), dtype=torch.int32,
                      device=packed.device)
    for t in range(grid_offset, nbw):
        rows = _arrival_rows(packed[t], B, L)
        for b in range(B):
            if auto_target:
                availi = availi + rows[b]
                tgt = availi.sum(1, dtype=torch.int32).clamp(max=max_coverage)
            else:
                tgt = target[:, t * B + b]
            _, avail, selend = _avail_step(avail, selend, rows[b], tgt)
            out[:, (t - grid_offset) * B + b] = selend[:, 0]
            avail, selend = _shift(avail), _shift(selend)
            if auto_target:
                availi = _shift(availi)
    return out, avail, selend, availi


def _kernel_b(entry, packed, counts, target, avail0, selend0, avail0i, W, B, L,
              grid_offset, auto_target, max_coverage, extra_ptrs=(), extra_sizes=()):
    """Launch kernel B's C entry ``entry`` on checked CUDA tensors, with
    ``extra_ptrs`` after its pointers and ``extra_sizes`` after its sizes;
    returns the outputs of ``blocked_sweep_pass``."""
    _check_cuda_span("sweep", B, L)
    if B > _CUDA_MAX_BLOCK:
        raise ValueError(f"CUDA sweep kernel supports block <= {_CUDA_MAX_BLOCK}; "
                         f"got block={B}")
    nbw, _, cap = packed.shape
    dev = packed.device
    args = [t.contiguous() for t in (counts, packed, avail0, selend0, avail0i)]
    tgt = target.contiguous() if target is not None else None
    out = torch.empty((W, (nbw - grid_offset) * B), dtype=torch.int32, device=dev)
    availf, selendf, availfi = (
        torch.empty((W, L), dtype=torch.int32, device=dev) for _ in range(3)
    )
    ptrs = [args[0].data_ptr(), args[1].data_ptr(),
            tgt.data_ptr() if tgt is not None else None,
            args[2].data_ptr(), args[3].data_ptr(), args[4].data_ptr(),
            out.data_ptr(), availf.data_ptr(), selendf.data_ptr(), availfi.data_ptr(),
            *extra_ptrs]
    sizes = [nbw, W, cap, B, L, grid_offset, int(auto_target), int(max_coverage),
             *extra_sizes]
    lib = build.load_kernels()
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(*ptrs, *sizes,
                                 torch.cuda.current_stream(dev).cuda_stream)
    build.check(entry, rc)
    return out, availf, selendf, availfi


def blocked_sweep_pass(
    packed, counts, target, avail0, selend0, n_windows, block, max_span, *,
    grid_offset=0, avail0i=None, auto_target=False, max_coverage=0,
):
    """One relaxation round over all W windows from the given carry seeds
    (kernel B). Returns ``(sel[W, (nbw - grid_offset) * B], availf[W, L],
    selendf[W, L], availfi[W, L])``, int32.

    ``packed`` int32 ``(nbw, W, cap)``: each group's codes first, in
    ascending order, then ``-1`` pads (the packer's layout); ``counts``
    int32 ``(nbw, W)``. ``target`` int32 ``(W, nbw * B)`` is the capped
    coverage; with ``auto_target`` it is None and the kernel derives
    ``min(coverage, max_coverage)`` from the untaken ring ``avail0i``.
    ``grid_offset = k`` sweeps only blocks ``k..nbw-1`` (cold-started from
    the given carries at block ``k``): the seed pre-pass of
    ``blocked_windowed_sweep``.

    On CUDA tensors the register path (``csrc/blocked_sweep.cu``) takes L
    in ``_CUDA_SPANS`` with at most ``_CUDA_MAX_STARTS`` reads of a group
    starting at one position; every other input goes to
    ``blocked_sweep_wide``. ``launches`` counts the register path's
    launches only."""
    if packed.device.type == "cpu":
        return blocked_sweep_pass_plain(
            packed, counts, target, avail0, selend0, n_windows, block,
            max_span, grid_offset=grid_offset, avail0i=avail0i,
            auto_target=auto_target, max_coverage=max_coverage,
        )
    if packed.device.type != "cuda":
        raise ValueError(f"no blocked sweep for device {packed.device}")
    W, B, L = n_windows, block, max_span
    avail0i = _sweep_args(packed, counts, target, avail0, selend0, avail0i,
                          W, B, L, grid_offset, auto_target)
    cap = packed.shape[2]
    # a group holds at most cap reads, so only a larger cap needs the count
    deep = cap > _CUDA_MAX_STARTS and _max_starts(packed, B, L) > _CUDA_MAX_STARTS
    kw = dict(grid_offset=grid_offset, avail0i=avail0i, auto_target=auto_target,
              max_coverage=max_coverage)
    if L not in _CUDA_SPANS or deep:
        return blocked_sweep_wide(packed, counts, target, avail0, selend0, W, B, L,
                                  **kw)
    res = _kernel_b("gd_blocked_sweep", packed, counts, target, avail0, selend0,
                    avail0i, W, B, L, grid_offset, auto_target, max_coverage)
    blocked_sweep_pass.launches += 1
    return res


blocked_sweep_pass.launches = 0


def blocked_sweep_wide(
    packed, counts, target, avail0, selend0, n_windows, block, max_span, *,
    grid_offset=0, avail0i=None, auto_target=False, max_coverage=0, tier=None,
):
    """``blocked_sweep_pass`` through kernel B's wide path
    (``csrc/blocked_sweep_wide.cu``) whatever L (a multiple of 32 with
    ``B * L < 2^31``; its tier ``wide_tier(B, L, auto_target, tier)``, the
    least that fits unless ``tier`` forces a higher one) and however many
    reads start at one position. ``blocked_sweep_pass`` sends it the inputs
    its register path does not take; a direct call times the wide path
    where both run. CPU tensors run the plain twin. ``launches`` counts its
    launches.

    Precondition of the CUDA kernel (not of the plain twin): each group's
    codes are sorted by start (``code // L``), as the packers emit them; the
    kernel reads each position's arrivals as one run of its group."""
    W, B, L = n_windows, block, max_span
    tier, _, words = wide_tier(B, L, auto_target, tier)
    if packed.device.type == "cpu":
        return blocked_sweep_pass_plain(
            packed, counts, target, avail0, selend0, n_windows, block,
            max_span, grid_offset=grid_offset, avail0i=avail0i,
            auto_target=auto_target, max_coverage=max_coverage,
        )
    if packed.device.type != "cuda":
        raise ValueError(f"no blocked sweep for device {packed.device}")
    avail0i = _sweep_args(packed, counts, target, avail0, selend0, avail0i,
                          W, B, L, grid_offset, auto_target)
    ws = torch.empty(W * words, dtype=torch.int32, device=packed.device) if words else None
    res = _kernel_b("gd_blocked_sweep_wide", packed, counts, target, avail0,
                    selend0, avail0i, W, B, L, grid_offset, auto_target,
                    max_coverage, (ws.data_ptr() if words else None,),
                    (4 * W * words, tier))
    blocked_sweep_wide.launches += 1
    return res


blocked_sweep_wide.launches = 0


def blocked_windowed_sweep(
    packed, counts, target, n_windows, block, max_span, *,
    seed_blocks=8, auto_target=False, max_coverage=0,
):
    """Exact global sweep by carry relaxation over ``blocked_sweep_pass``.

    Returns ``(sel_per_end[W * win], rounds)``. A pre-pass over the last
    ``seed_blocks`` blocks of every window (cold-started) seeds round 1
    with near-exact boundary carries; each round then seeds window ``w``
    with window ``w-1``'s carry-out of the previous round, until all three
    carries (avail, selend, availi) are stable. At that point window 0 ran
    from the true genome-start state, so by induction every window's
    result equals the global sequential sweep. Window corrections move at
    least one window per round, so ``W + 1`` rounds bound the loop."""
    W, L = n_windows, max_span
    nbw = packed.shape[0]
    dev = packed.device

    def passes(a_in, s_in, ai_in, grid_offset=0):
        return blocked_sweep_pass(
            packed, counts, target, a_in, s_in, W, block, L,
            grid_offset=grid_offset, avail0i=ai_in,
            auto_target=auto_target, max_coverage=max_coverage,
        )

    def shift(c_out):
        return torch.cat(
            [torch.zeros((1, L), dtype=torch.int32, device=dev), c_out[:-1]]
        )

    zeros = torch.zeros((W, L), dtype=torch.int32, device=dev)
    if seed_blocks > 0 and W > 1 and nbw > seed_blocks:
        _, a_t, s_t, ai_t = passes(zeros, zeros, zeros, nbw - seed_blocks)
        a_in, s_in, ai_in = shift(a_t), shift(s_t), shift(ai_t)
    else:
        a_in, s_in, ai_in = zeros, zeros, zeros
    sel, a_out, s_out, ai_out = passes(a_in, s_in, ai_in)
    rounds = 1
    while rounds < W + 1:
        a_nx, s_nx, ai_nx = shift(a_out), shift(s_out), shift(ai_out)
        stable = (
            torch.equal(a_nx, a_in) and torch.equal(s_nx, s_in)
            and torch.equal(ai_nx, ai_in)
        )
        if stable:
            break
        a_in, s_in, ai_in = a_nx, s_nx, ai_nx
        sel, a_out, s_out, ai_out = passes(a_in, s_in, ai_in)
        rounds += 1
    return sel.reshape(-1), rounds


def _selection_args(packed, counts, sel, xwin, W, B, L):
    nbw, Wp, cap = packed.shape
    dev = packed.device
    if Wp != W:
        raise ValueError(f"packed has {Wp} windows, n_windows={W}")
    _check_i32("packed", packed, (nbw, W, cap), dev)
    _check_i32("counts", counts, (nbw, W), dev)
    _check_i32("sel", sel, (W * nbw * B,), dev)
    _check_i32("xwin", xwin, (W, B + L), dev)


def blocked_selection_pass_plain(packed, counts, sel, xwin, n_windows, block,
                                 max_span):
    """Plain torch twin of ``blocked_selection_pass``: the same rank
    decomposition, one block of all W windows per Python iteration, with
    the within-group rank from one sort of the block's slots by (window,
    end, start, slot), so its memory is O(W cap), not O(W cap^2)."""
    W, B, L = n_windows, block, max_span
    _selection_args(packed, counts, sel, xwin, W, B, L)
    nbw, _, cap = packed.shape
    dev = packed.device
    win = nbw * B
    # sel with its halo: each window continues into the next one's head,
    # the last into zeros (the global end coordinate, read past the window)
    sel_ext = torch.cat([sel, torch.zeros(B + L, dtype=torch.int32, device=dev)])
    w_idx = torch.arange(W, device=dev)[:, None]
    w_base = w_idx * win
    slot = torch.arange(cap, device=dev)
    idx = torch.arange(W * cap, device=dev)
    acc = xwin.clone()
    out = torch.zeros((nbw, W, cap), dtype=torch.int8, device=dev)
    for t in range(nbw):
        codes = packed[t]
        valid = codes >= 0
        c = codes.clamp(min=0).to(torch.int64)
        sr = c // L
        er = sr + c % L
        # rank_in_group[w, s] = # valid j: same end and (start_j < start_s
        # or same start and j before s) = s's place among the valid slots
        # sorted by (window, end, start, slot) less its end's first place
        # (sr < B, er < B + L; pads sort last)
        bucket = (w_idx * (B + L) + er) * B * cap
        key = torch.where(valid, bucket + sr * cap + slot, W * (B + L) * B * cap)
        keys, order = torch.sort(key.reshape(-1))
        place = torch.empty_like(order)
        place[order] = idx
        rank = (place - torch.searchsorted(keys, bucket.reshape(-1))).reshape(W, cap)
        rank = rank.to(torch.int32) + torch.gather(acc, 1, er)
        quota = sel_ext[(w_base + t * B + er).reshape(-1)].reshape(W, cap)
        out[t] = ((rank < quota) & valid).to(torch.int8)
        coltot = torch.zeros((W, B + L), dtype=torch.int32, device=dev)
        coltot.scatter_add_(1, er, valid.to(torch.int32))
        acc = torch.nn.functional.pad((acc + coltot)[:, B:], (0, B))
    return out


def blocked_selection_pass(packed, counts, sel, xwin, n_windows, block,
                           max_span, *, path=None):
    """Selection byte per packed slot (kernel C): 1 iff the slot's read
    ranks, in its end bucket ordered by (start, read index), below
    ``sel[end]``. ``sel`` int32 ``[W * nbw * B]`` is the sweep output;
    ``xwin`` int32 ``(W, B + L)`` counts reads of earlier windows ending at
    each window-relative position. Returns int8 ``(nbw, W, cap)``. On CUDA
    tensors the kernel runs ``select_path(B, L, path)``: its tile while it
    fits, else (or with ``path="hash"``) its hash path.

    Precondition of the CUDA kernel (not of the plain twin): each group's
    codes are sorted ascending, equal codes in read-index order, as the
    packers emit them. The kernel then ranks a read by the earlier slots of
    its group with the same end."""
    W, B, L = n_windows, block, max_span
    path = select_path(B, L, path)
    if packed.device.type == "cpu":
        return blocked_selection_pass_plain(
            packed, counts, sel, xwin, n_windows, block, max_span
        )
    if packed.device.type != "cuda":
        raise ValueError(f"no selection pass for device {packed.device}")
    _selection_args(packed, counts, sel, xwin, W, B, L)
    _check_cuda_span("selection", B, L)
    nbw, _, cap = packed.shape
    dev = packed.device
    p, c, s, x = (t.contiguous() for t in (packed, counts, sel, xwin))
    out = torch.empty((nbw, W, cap), dtype=torch.int8, device=dev)
    lib = build.load_kernels()
    with torch.cuda.device(dev):
        rc = lib.gd_blocked_select(
            p.data_ptr(), c.data_ptr(), s.data_ptr(), x.data_ptr(),
            out.data_ptr(), nbw, W, cap, B, L, int(path == "hash"),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check("gd_blocked_select", rc)
    blocked_selection_pass.launches += 1
    return out


blocked_selection_pass.launches = 0
