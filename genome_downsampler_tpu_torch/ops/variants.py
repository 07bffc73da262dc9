"""Kernel A's two experimental variants and their twins.

Counterpart of ``make_variant_c`` and ``make_variant_b`` in the JAX
package's ``scripts/kernel_variants.py``: the dense sweep of one row from
zero carries, written two other ways, to time against kernel A
(``ops/sweep.py``). Both give kernel A's ``sel_per_end``.

- ``sweep_variant_c`` (variant C): the avail-form step, branch-free, with a
  full inclusive prefix scan of the ring on every step.
- ``sweep_variant_b`` (variant B): an absolute-slot ring, slot ``e % L``
  for the reads ending at ``e``, so the ring never shifts; the take split
  reads a prefix rotated to start at the expiring slot. It takes rows
  rotated by ``rotate_rows``, outside the kernel.

Rows are raw arrival histograms ``rows[j, k]`` = # reads starting at ``j``
with span ``k + 1`` (``build_start_rows``), one row ``(n, L)`` as in the
JAX script. Each wrapper runs its plain twin on CPU tensors and its CUDA
kernel (``csrc/sweep_variants.cu``) on CUDA tensors, or raises;
``launches`` on each counts its kernel launches (an empty row launches
nothing). The kernels run on kernel A's frame: one CTA of a sweep warp and
three producer warps per row, chunks of ``chunk_positions(L)`` positions
in a double buffer of ``shared_bytes(L)`` bytes of shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from genome_downsampler_tpu_torch.ops import build
from genome_downsampler_tpu_torch.ops.blocked import _avail_step, _check_i32
from genome_downsampler_tpu_torch.ops.sweep import dense_sweep_counts_plain

# ring widths the CUDA variants take
_CUDA_SPANS = (32, 64, 128, 256)


def chunk_positions(L: int) -> int:
    """Positions per chunk of the CUDA variants at ring width ``L`` (the
    kernel's ``chunk_positions``): the largest power of two up to 512 for
    which two int32 ``(P, L)`` buffers fit 192 KB."""
    p = 512
    while 2 * p * L * 4 > 192 * 1024:
        p //= 2
    return p


def shared_bytes(L: int) -> int:
    """Dynamic shared memory of one CTA at ring width ``L``: the two row
    buffers, and two chunks each of targets and emitted counts."""
    p = chunk_positions(L)
    return 4 * (2 * p * L + 4 * p)


def kernel_info(L: int, ring: bool) -> dict:
    """What the built kernel of variant B (``ring``) or C at ``L`` reports:
    ``{"chunk_positions", "shared_bytes", "registers", "local_bytes"}``
    (``local_bytes`` > 0 means spills). Needs the CUDA library."""
    info = (ctypes.c_int64 * 4)()
    lib = build.load_kernels()
    build.check("gd_sweep_variant_info",
                lib.gd_sweep_variant_info(L, int(ring), ctypes.addressof(info)))
    return dict(zip(("chunk_positions", "shared_bytes", "registers", "local_bytes"),
                    info))


def rotate_rows(rows: torch.Tensor) -> torch.Tensor:
    """Variant B's input: ``out[p, (p + k) % L] = rows[p, k]``, so column
    ``x`` counts the reads starting at ``p`` that end at ``e`` with
    ``e % L == x``."""
    n, L = rows.shape
    p = torch.arange(n, device=rows.device)[:, None]
    x = torch.arange(L, device=rows.device)[None, :]
    return torch.gather(rows, 1, (x - p) % L)


def _variant_args(rows, target, max_span):
    if rows.dim() != 2:
        raise ValueError(f"rows: expected int32[n, L], got {list(rows.shape)}")
    n, L = rows.shape
    if L != max_span:
        raise ValueError(f"rows have {L} span slots, max_span={max_span}")
    _check_i32("rows", rows, (n, L), rows.device)
    _check_i32("target", target, (n,), rows.device)
    for name, x in (("rows", rows), ("target", target)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n, L


def sweep_variant_c_plain(rows, target, max_span):
    """Plain twin of ``sweep_variant_c``: variant C computes kernel A's step,
    so this is kernel A's twin on one row from zero carries."""
    _, L = _variant_args(rows, target, max_span)
    z = torch.zeros((1, L), dtype=torch.int32, device=rows.device)
    return dense_sweep_counts_plain(rows[None], target[None], z, z, L)[0][0]


def sweep_variant_b_plain(rows_rot, target, max_span):
    """Plain twin of ``sweep_variant_b``: the same step on the ring read from
    the expiring slot ``p % L`` onward, which is ascending end order; that
    slot is emitted, then emptied."""
    n, L = _variant_args(rows_rot, target, max_span)
    avail = torch.zeros((1, L), dtype=torch.int32, device=rows_rot.device)
    selend = torch.zeros_like(avail)
    out = torch.empty(n, dtype=torch.int32, device=rows_rot.device)
    for p in range(n):
        s = p % L
        _, a, se = _avail_step(
            torch.roll(avail, -s, 1), torch.roll(selend, -s, 1),
            torch.roll(rows_rot[p:p + 1], -s, 1), target[p:p + 1],
        )
        out[p] = se[0, 0]
        a[0, 0] = se[0, 0] = 0
        avail, selend = torch.roll(a, s, 1), torch.roll(se, s, 1)
    return out


def _launch(entry, rows, target, max_span, fn):
    n, L = _variant_args(rows, target, max_span)
    if L not in _CUDA_SPANS:
        raise ValueError(
            f"CUDA sweep variants support max_span in {_CUDA_SPANS}; got {L}"
        )
    if rows.device.type != "cuda":
        raise ValueError(f"no sweep variant for device {rows.device}")
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned (the kernel copies "
                         "16-byte pieces)")
    out = torch.empty(n, dtype=torch.int32, device=rows.device)
    if n == 0:
        return out
    lib = build.load_kernels()
    with torch.cuda.device(rows.device):
        rc = getattr(lib, entry)(
            rows.data_ptr(), target.data_ptr(), out.data_ptr(), n, L,
            torch.cuda.current_stream(rows.device).cuda_stream,
        )
    build.check(entry, rc)
    fn.launches += 1
    return out


def sweep_variant_c(rows, target, max_span):
    """Variant C of kernel A: ``sel_per_end[n]`` int32 of one row ``rows``
    int32 ``[n, L]`` with capped target ``target`` int32 ``[n]``, from zero
    carries."""
    if rows.device.type == "cpu":
        return sweep_variant_c_plain(rows, target, max_span)
    return _launch("gd_sweep_variant_c", rows, target, max_span, sweep_variant_c)


def sweep_variant_b(rows_rot, target, max_span):
    """Variant B of kernel A: as ``sweep_variant_c``, from the rotated rows
    ``rotate_rows(rows)``."""
    if rows_rot.device.type == "cpu":
        return sweep_variant_b_plain(rows_rot, target, max_span)
    return _launch("gd_sweep_variant_b", rows_rot, target, max_span,
                   sweep_variant_b)


sweep_variant_c.launches = 0
sweep_variant_b.launches = 0
