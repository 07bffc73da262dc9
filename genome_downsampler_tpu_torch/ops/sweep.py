"""Dense water-filling sweep over S independent rows: kernel A and its twin.

Counterpart of the JAX package's ``ops/pallas_sweep.py``
(``pallas_sweep_counts``) with a row axis: each of the S rows is one
sequential sweep over its n positions (the algorithm is described in
``solvers/device_sweep.py``). One kernel serves four paths: S = 1 is the
dense engine of ``McpDeviceSweepSolver``, S = W the windows of
``WindowedMcpSolver``, S = #samples ``solve_batch``, and ``takes=True``
the take matrix of ``QmcpDeviceSweepSolver``.

``dense_sweep_counts`` runs the plain torch twin on CPU tensors and the
CUDA kernel (``csrc/dense_sweep.cu``) on CUDA tensors, or raises;
``dense_sweep_counts.launches`` counts its kernel launches.

Rows are raw arrival histograms, ``rows[s, j, k]`` = # reads of row s
starting at position j with span ``k + 1`` (``build_start_rows``); carries
are int32 ``(S, L)`` in avail form: ``avail[k]`` unselected and
``selend[k]`` selected reads covering the position whose end is ``k``
positions ahead.
"""

from __future__ import annotations

import torch

from genome_downsampler_tpu_torch.ops import build
from genome_downsampler_tpu_torch.ops.blocked import (
    _CUDA_SPANS,
    _avail_step,
    _check_i32,
    _shift,
)


def _sweep_args(rows, target, avail0, selend0, max_span):
    if rows.dim() != 3:
        raise ValueError(f"rows: expected int32[S, n, L], got {list(rows.shape)}")
    S, n, L = rows.shape
    if L != max_span:
        raise ValueError(f"rows have {L} span slots, max_span={max_span}")
    dev = rows.device
    _check_i32("rows", rows, (S, n, L), dev)
    _check_i32("target", target, (S, n), dev)
    _check_i32("avail0", avail0, (S, L), dev)
    _check_i32("selend0", selend0, (S, L), dev)
    for name, x in (("rows", rows), ("target", target), ("avail0", avail0),
                    ("selend0", selend0)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return S, n, L


def dense_sweep_counts_plain(rows, target, avail0, selend0, max_span, *,
                             takes=False):
    """Plain torch twin of ``dense_sweep_counts``: the avail-form step of
    ``sweep_counts`` over all S rows at once, one position per Python
    iteration."""
    S, n, L = _sweep_args(rows, target, avail0, selend0, max_span)
    avail, selend = avail0.clone(), selend0.clone()
    shape = (S, n, L) if takes else (S, n)
    out = torch.empty(shape, dtype=torch.int32, device=rows.device)
    for j in range(n):
        take, avail, selend = _avail_step(avail, selend, rows[:, j], target[:, j])
        if takes:
            out[:, j] = take
        else:
            out[:, j] = selend[:, 0]
        avail, selend = _shift(avail), _shift(selend)
    return out, avail, selend


def dense_sweep_counts(rows, target, avail0, selend0, max_span, *, takes=False):
    """Sweep every row from its carry-in (kernel A).

    ``rows`` int32 ``[S, n, L]``, ``target`` int32 ``[S, n]`` (the capped
    coverage), ``avail0``/``selend0`` int32 ``[S, L]``, all contiguous on one
    device. Returns ``(sel_per_end[S, n], avail_out[S, L],
    selend_out[S, L])``; with ``takes=True`` the first result is instead
    ``takes[S, n, L]``, ``takes[s, j, k]`` = reads taken at position ``j``
    from the bucket ending at ``j + k`` (``sweep_counts_with_takes``)."""
    if rows.device.type == "cpu":
        return dense_sweep_counts_plain(
            rows, target, avail0, selend0, max_span, takes=takes
        )
    if rows.device.type != "cuda":
        raise ValueError(f"no dense sweep for device {rows.device}")
    S, n, L = _sweep_args(rows, target, avail0, selend0, max_span)
    if L not in _CUDA_SPANS:
        raise ValueError(
            f"CUDA dense sweep kernel supports max_span in {_CUDA_SPANS}; "
            f"got {L}"
        )
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned (the kernel copies "
                         "16-byte pieces)")
    dev = rows.device
    if takes:
        out = None
        tk = torch.empty((S, n, L), dtype=torch.int32, device=dev)
    else:
        out = torch.empty((S, n), dtype=torch.int32, device=dev)
        tk = None
    availf, selendf = (
        torch.empty((S, L), dtype=torch.int32, device=dev) for _ in range(2)
    )
    lib = build.load_kernels()
    with torch.cuda.device(dev):
        rc = lib.gd_dense_sweep(
            rows.data_ptr(), target.data_ptr(), avail0.data_ptr(),
            selend0.data_ptr(), out.data_ptr() if out is not None else None,
            tk.data_ptr() if tk is not None else None, availf.data_ptr(),
            selendf.data_ptr(), S, n, L, int(takes),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check("gd_dense_sweep", rc)
    dense_sweep_counts.launches += 1
    return (tk if takes else out), availf, selendf


dense_sweep_counts.launches = 0
