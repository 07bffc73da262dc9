"""Reads generated and packed on the device: config-5's pack kernel and its
plain twin.

Counterpart of the ``build`` program of the JAX package's
``scripts/bench_chr1.py`` (``:147-181``). Read ``i`` of ``r`` starts at the
Weyl point ``((i * 2654435761) mod 2^32) mod (n - read_len + 1)`` and spans
``read_len`` bases; nothing is read from the host. ``pack_reads`` buckets
the reads into the blocked engine's ``(block t, window w)`` groups of codes
``(start % B) * L + read_len - 1`` (``ops/blocked.py``'s layout, group
``t * W + w``) and returns the coverage difference, from which
``capped_target`` makes the sweep's target ``min(coverage, M)``.

Two things differ from ``build``, which runs its kernel B under the
TPU-only ``static_chunks`` switch with zero counts: ``pack_reads`` returns
``counts[nbw, W]``, the codes of each group, which kernel B reads, and each
group's codes are sorted ascending before the ``-1`` pads, as the port's
packers emit them.

``pack_reads`` runs the plain twin ``pack_reads_plain`` (an argsort of the
groups) on the CPU and the CUDA kernel (``csrc/device_pack.cu``) on a card,
or raises; ``pack_reads.launches`` counts its kernel launches. The kernel
goes by position, not by read. The multiplier ``WEYL`` is odd, so ``i ->
(i * WEYL) mod 2^32`` is a bijection of ``[0, 2^32)`` with the inverse
``WEYL_INVERSE``; the reads that start at ``s`` are exactly the ``i < r``
among ``((s + j * m) * WEYL_INVERSE) mod 2^32`` for the ``j`` with ``s + j *
m < 2^32`` (``m = n - read_len + 1``), and since ``r < 2^31`` each read is
one such candidate of one position. A CTA counts its run of positions'
starts ``c(s)`` that way (``2^32`` candidates in all, whatever ``r`` is),
and every output follows from ``c``: a group's row is ``c(s)`` copies of
each position's code in order, then ``-1``; ``counts`` the block's sum;
``diff[s] = c(s) - c(s - read_len)``. Each output element is written once,
with no atomic on ``packed`` or ``diff`` and no sort; what bounds it is the
outputs' bytes and the candidates' integer operations (the source's note).
"""

from __future__ import annotations

import torch

from genome_downsampler_tpu_torch.ops import build

WEYL = 2654435761
WEYL_INVERSE = 244002641  # WEYL * WEYL_INVERSE = 1 mod 2^32
# the kernel keeps a run's start counts and the read_len before it, at most
# 2 * 4096 + 1 ints, in shared memory; a run is at least one block
# (csrc/device_pack.cu)
MAX_BLOCK = 4096


def geometry(n: int, windows: int, block: int) -> tuple[int, int, int]:
    """``(win, nbw, n_pad)``: positions a window (a multiple of ``block``
    covering ``ceil(n / windows)``), blocks a window, and ``windows * win``."""
    win = -(-(-(-n // windows)) // block) * block
    return win, win // block, windows * win


def weyl_starts(r: int, n: int, read_len: int, device) -> torch.Tensor:
    """The starts int64[r]: the uint32 Weyl product in int64, masked to 32
    bits (below 2^63 for r < 2^33)."""
    i = torch.arange(r, dtype=torch.int64, device=device)
    return ((i * WEYL) & 0xFFFFFFFF) % (n - read_len + 1)


def _check_args(r, n, windows, block, span, cap, read_len):
    win, nbw, n_pad = geometry(n, windows, block)
    if not (1 <= r < 1 << 31 and 1 <= read_len <= n and read_len <= span
            and n_pad < 1 << 31 and block * span < 1 << 31 and 1 <= block <= MAX_BLOCK
            and cap >= 1):
        raise ValueError(
            f"device pack takes 1 <= reads < 2^31, read_len <= min(n, max_span), "
            f"W * win < 2^31, block * max_span < 2^31, block <= {MAX_BLOCK} and cap >= 1; got "
            f"reads={r}, n={n}, W={windows}, block={block}, max_span={span}, "
            f"cap={cap}, read_len={read_len}")
    return win, nbw, n_pad


def _check_fill(fill: int, cap: int) -> None:
    if fill > cap:
        raise ValueError(f"a group holds {fill} reads, more than cap={cap}: raise cap")


def pack_reads_plain(r, n, windows, device, *, block, span, cap, read_len):
    """Plain torch twin of ``pack_reads``: the groups by one argsort of
    (group, code), each read's rank in its group from the counts."""
    win, nbw, n_pad = _check_args(r, n, windows, block, span, cap, read_len)
    dev = torch.device(device)
    s = weyl_starts(r, n, read_len, dev)
    code = (s % block) * span + (read_len - 1)
    group = ((s % win) // block) * windows + s // win
    counts = torch.bincount(group, minlength=nbw * windows)
    fill = int(counts.max())
    _check_fill(fill, cap)
    order = torch.argsort(group * (block * span) + code)
    g = group[order]
    rank = torch.arange(r, dtype=torch.int64, device=dev) - (torch.cumsum(counts, 0) - counts)[g]
    packed = torch.full((nbw * windows * cap,), -1, dtype=torch.int32, device=dev)
    packed[g * cap + rank] = code[order].to(torch.int32)
    one = torch.ones(r, dtype=torch.int32, device=dev)
    diff = torch.zeros(n_pad + 1, dtype=torch.int32, device=dev)
    diff.index_add_(0, s, one)
    diff.index_add_(0, s + read_len, -one)
    return (packed.reshape(nbw, windows, cap), counts.to(torch.int32).reshape(nbw, windows),
            diff, fill)


def pack_reads(r, n, windows, device, *, block, span, cap, read_len):
    """Generate ``r`` Weyl reads of ``read_len`` bases over ``n`` bases on
    ``device`` and pack them for ``W = windows`` windows of ``block``-position
    blocks at ``L = span``. Returns ``(packed int32[nbw, W, cap], counts
    int32[nbw, W], diff int32[W * win + 1], fill)``: each group's codes
    ascending, then ``-1`` pads; the coverage difference (+1 at each start,
    -1 past each end); the largest group. Raises when a group holds more
    than ``cap`` reads, as the JAX script asserts."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return pack_reads_plain(r, n, windows, dev, block=block, span=span, cap=cap,
                                read_len=read_len)
    if dev.type != "cuda":
        raise ValueError(f"no device pack for device {dev}")
    win, nbw, n_pad = _check_args(r, n, windows, block, span, cap, read_len)
    # the kernel writes every element; its C entry zeroes fill first
    packed = torch.empty((nbw, windows, cap), dtype=torch.int32, device=dev)
    counts = torch.empty((nbw, windows), dtype=torch.int32, device=dev)
    diff = torch.empty(n_pad + 1, dtype=torch.int32, device=dev)
    fill = torch.empty(1, dtype=torch.int32, device=dev)
    lib = build.load_kernels()
    with torch.cuda.device(dev):
        rc = lib.gd_device_pack(
            packed.data_ptr(), counts.data_ptr(), diff.data_ptr(), fill.data_ptr(),
            r, n, read_len, windows, win, block, span, cap,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check("gd_device_pack", rc)
    pack_reads.launches += 1
    fill = int(fill)
    _check_fill(fill, cap)
    return packed, counts, diff, fill


pack_reads.launches = 0


def capped_target(diff: torch.Tensor, max_coverage: int, windows: int) -> torch.Tensor:
    """``min(coverage, M)`` int32 ``(W, win)`` from ``pack_reads``'s
    coverage difference: a scan and a clamp, torch ops on its device."""
    cov = torch.cumsum(diff[:-1], 0, dtype=torch.int32)
    return cov.clamp_(max=int(max_coverage)).reshape(windows, -1)
