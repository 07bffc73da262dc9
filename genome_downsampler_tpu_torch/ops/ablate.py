"""The ablation of the blocked sweep's step, and its twin.

Counterpart of ``make_kernel`` in the JAX package's
``scripts/bench_kernel_ablate.py``: kernel B's step (``ops/blocked.py``)
over W independent windows from zero carries, with pieces removed by
``mode`` to attribute its time per position. Only ``full`` is a correct
sweep (of each window alone, with no carry between windows); the other
modes exist to be timed.

Per window and block of B positions, an arrival tile ``(B, L)`` is built
from the packed codes (``_arrival_rows``) and its lane ``L - 1`` is
overwritten by the target, so reads of span ``L`` count nowhere; ``cur``
is re-synced to ``sum(selend)`` at the start of every block. Per position:

- ``addonly`` folds the arrivals into ``avail`` and stops;
- ``notake`` skips the take split;
- ``noemit`` skips the store of ``selend[0]`` to ``out``;
- ``noroll`` skips the shift of both rings, so ``cur`` drifts from
  ``sum(selend)`` until the next block's re-sync;
- ``tileonly`` builds the tiles and sweeps nothing, ``emptyloop`` runs a
  loop of counter steps over them.

``out`` is defined in ``full``, ``notake`` and ``noroll`` and zero in the
other modes. ``blocked_ablate`` runs the twin on CPU tensors and the CUDA
kernel (``csrc/blocked_ablate.cu``) on CUDA tensors, or raises;
``blocked_ablate.launches`` counts its kernel launches. The kernel runs on
kernel B's frame (``csrc/blocked_sweep.cu``): one CTA of a sweep warp and
three producer warps per window, chunks of ``chunk_positions(B)``
positions in a double buffer of ``shared_bytes(B, L)`` bytes of shared
memory, uint16 arrival counts.
"""

from __future__ import annotations

import ctypes

import torch

from genome_downsampler_tpu_torch.ops import build
from genome_downsampler_tpu_torch.ops.blocked import (
    _CUDA_MAX_STARTS,
    _arrival_rows,
    _check_i32,
    _max_starts,
    _shift,
)

MODES = ("full", "notake", "noroll", "noemit", "addonly", "tileonly",
         "emptyloop")
#: the modes that write ``out``
EMITTING = ("full", "notake", "noroll")
# ring widths the CUDA kernel takes (one template instantiation each)
_CUDA_SPANS = (32, 64, 128, 256)


def chunk_positions(B: int) -> int:
    """Positions per chunk of the CUDA kernel at block ``B`` (the kernel's
    ``chunk_positions``): chunks are cut within a block."""
    return min(B, 128)


def shared_bytes(B: int, L: int) -> int:
    """Dynamic shared memory of one CTA: two uint16 ``(P, L)`` tiles, and
    two chunks each of targets and emitted counts."""
    p = chunk_positions(B)
    return 2 * 2 * p * L + 4 * 4 * p


def kernel_info(B: int, L: int, mode: str) -> dict:
    """What the built kernel of ``mode`` at ``L`` reports at block ``B``:
    ``{"chunk_positions", "shared_bytes", "registers", "local_bytes"}``
    (``local_bytes`` > 0 means spills). Needs the CUDA library."""
    info = (ctypes.c_int64 * 4)()
    lib = build.load_kernels()
    build.check("gd_blocked_ablate_info",
                lib.gd_blocked_ablate_info(B, L, MODES.index(mode),
                                           ctypes.addressof(info)))
    return dict(zip(("chunk_positions", "shared_bytes", "registers", "local_bytes"),
                    info))


def _ablate_args(packed, target, W, B, L, mode):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    if packed.dim() != 3:
        raise ValueError(f"packed: expected int32[nbw, W, cap], got {list(packed.shape)}")
    nbw, Wp, cap = packed.shape
    if Wp != W:
        raise ValueError(f"packed has {Wp} windows, n_windows={W}")
    if B < 2 or B % 2:
        raise ValueError(f"block must be even (the step runs in pairs); got {B}")
    _check_i32("packed", packed, (nbw, W, cap), packed.device)
    _check_i32("target", target, (W, nbw * B), packed.device)
    for name, x in (("packed", packed), ("target", target)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return nbw


def blocked_ablate_plain(packed, target, n_windows, block, max_span, mode):
    """Plain twin of ``blocked_ablate``: all W windows at once, one
    position per Python iteration."""
    W, B, L = n_windows, block, max_span
    nbw = _ablate_args(packed, target, W, B, L, mode)
    dev = packed.device
    avail = torch.zeros((W, L), dtype=torch.int32, device=dev)
    selend = torch.zeros_like(avail)
    out = torch.zeros((W, nbw * B), dtype=torch.int32, device=dev)
    for t in range(nbw):
        tile = _arrival_rows(packed[t], B, L)
        tile[:, :, L - 1] = target[:, t * B:(t + 1) * B].T
        if mode in ("tileonly", "emptyloop"):
            continue
        cur = selend.sum(1, dtype=torch.int32)
        for b in range(B):
            tgt = tile[b, :, L - 1]
            avail = avail + torch.nn.functional.pad(tile[b, :, :L - 1], (0, 1))
            if mode == "addonly":
                continue
            deficit = tgt - cur
            if mode != "notake":
                csum = torch.cumsum(avail, 1, dtype=torch.int32)
                total = csum[:, L - 1]
                take = torch.minimum(
                    (deficit[:, None] - (total[:, None] - csum)).clamp(min=0), avail
                )
                avail, selend = avail - take, selend + take
                cur = cur + torch.minimum(deficit.clamp(min=0), total)
            em = selend[:, 0]
            if mode != "noemit":
                out[:, t * B + b] = em
            if mode != "noroll":  # noroll: lane L-1 of both rings is 0 already
                avail, selend = _shift(avail), _shift(selend)
            cur = cur - em
    return out, avail, selend


def _launch(packed, target, W, B, L, mode):
    """The CUDA kernel on checked tensors, or a ``ValueError`` naming the
    bound it does not take; never the twin."""
    nbw = _ablate_args(packed, target, W, B, L, mode)
    if L not in _CUDA_SPANS:
        raise ValueError(
            f"CUDA ablation kernel supports max_span in {_CUDA_SPANS}; got "
            f"max_span={L}"
        )
    # a group holds at most cap reads, so only a larger cap needs the count
    if packed.shape[2] > _CUDA_MAX_STARTS:
        most = _max_starts(packed, B, L)
        if most > _CUDA_MAX_STARTS:
            raise ValueError(
                f"CUDA ablation kernel takes at most {_CUDA_MAX_STARTS} reads of a "
                f"window starting at one position (its arrival tile counts in "
                f"uint16); got {most}"
            )
    if packed.device.type != "cuda":
        raise ValueError(f"no ablation kernel for device {packed.device}")
    dev = packed.device
    alloc = torch.empty if mode in EMITTING else torch.zeros
    out = alloc((W, nbw * B), dtype=torch.int32, device=dev)
    availf, selendf = (
        torch.empty((W, L), dtype=torch.int32, device=dev) for _ in range(2)
    )
    lib = build.load_kernels()
    with torch.cuda.device(dev):
        rc = lib.gd_blocked_ablate(
            packed.data_ptr(), target.data_ptr(), out.data_ptr(),
            availf.data_ptr(), selendf.data_ptr(), nbw, W, packed.shape[2], B,
            L, MODES.index(mode), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check("gd_blocked_ablate", rc)
    blocked_ablate.launches += 1
    return out, availf, selendf


def blocked_ablate(packed, target, n_windows, block, max_span, mode):
    """One ablation pass (``make_kernel``) over W windows.

    ``packed`` int32 ``(nbw, W, cap)``: each (block, window) group's codes
    ``start_rel * L + span - 1``, ``-1`` pads (``_native.pack_blocked``);
    ``target`` int32 ``(W, nbw * B)``, the capped coverage. Returns
    ``(out[W, nbw * B], availf[W, L], selendf[W, L])`` int32.

    On CUDA tensors the kernel takes L in ``_CUDA_SPANS``, any even B and at
    most ``_CUDA_MAX_STARTS`` reads of a window starting at one position."""
    if packed.device.type == "cpu":
        return blocked_ablate_plain(packed, target, n_windows, block, max_span,
                                    mode)
    return _launch(packed, target, n_windows, block, max_span, mode)


blocked_ablate.launches = 0
