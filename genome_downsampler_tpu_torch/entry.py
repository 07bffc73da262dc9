"""Entry points: the flagship sweep on one device, and the multi-rank dry
run.

``entry`` is the torch form of the JAX package's ``__graft_entry__.entry``:
it returns
``(fn, example_args)`` such that ``fn(*example_args)`` runs the dense
water-filling sweep (``ops.sweep.dense_sweep_counts``, kernel A on a CUDA
device, its plain twin on the CPU) at n = 1024 positions, L = 128, on the
named device. The inputs are those of the JAX entry (the same numpy seed),
so the two results are comparable. ``dryrun_multichip`` is the form of
its ``dryrun_multichip``: both mesh engines at the process group's rank
count, bit-equal to the sequential sweep.
"""

from __future__ import annotations

import numpy as np
import torch

from genome_downsampler_tpu_torch.device import resolve_device
from genome_downsampler_tpu_torch.ops.sweep import dense_sweep_counts

MAX_SPAN = 128
N = 1024


def entry(device: str | torch.device):
    """``(fn, (rows[1, n, L], target[1, n], avail0[1, L], selend0[1, L]))``
    on ``device`` (``"cuda"`` or ``"cpu"``)."""
    dev = resolve_device(device)

    def fn(rows, target, avail0, selend0):
        return dense_sweep_counts(rows, target, avail0, selend0, MAX_SPAN)

    rng = np.random.default_rng(0)
    rows = (rng.random((N, MAX_SPAN)) < 0.02).astype(np.int32)
    target = rng.integers(0, 4, N).astype(np.int32)
    zeros = torch.zeros((1, MAX_SPAN), dtype=torch.int32, device=dev)
    return fn, (
        torch.from_numpy(rows)[None].to(dev),
        torch.from_numpy(target)[None].to(dev),
        zeros,
        zeros.clone(),
    )


def dryrun_multichip(device: str | torch.device = "cuda") -> dict:
    """The JAX package's ``__graft_entry__.dryrun_multichip`` at this
    world's rank count: both mesh engines (``parallel.mesh``,
    ``parallel.blocked_mesh``) over 64 positions a rank must be bit-equal
    to the sequential global sweep (``solvers.device_sweep.sweep_counts``,
    the plain torch sweep, on the same device). Every rank makes the same
    reads from seed 0 and builds only its own window.

    ``max_span`` is 16 on the CPU, as in JAX, and 32 on the card: kernels A
    and B take no L below 32. The blocked engine keeps JAX's 2 windows a
    rank and blocks of 16, which kernel B takes (any block from 1 to 256).
    Returns the rank count, L and each engine's rounds; raises
    AssertionError on a mismatch."""
    from genome_downsampler_tpu_torch.ops.coverage import (
        capped_coverage,
        coverage_from_intervals,
    )
    from genome_downsampler_tpu_torch.parallel.launch import global_window_mesh
    from genome_downsampler_tpu_torch.parallel.mesh import solve_on_mesh
    from genome_downsampler_tpu_torch.parallel.sharded_io import solve_blocked_on_mesh
    from genome_downsampler_tpu_torch.solvers.device_sweep import (
        build_start_rows,
        sweep_counts,
    )

    mesh = global_window_mesh(device)
    n_devices = mesh.size
    max_span = 16 if mesh.device.type == "cpu" else 32
    win, m = 64, 3
    n = win * n_devices

    rng = np.random.default_rng(0)
    starts = rng.integers(0, n - max_span, 32 * n_devices)
    spans = rng.integers(4, max_span, starts.shape[0])
    ends = starts + spans - 1

    # the exactness yardstick: the sequential global sweep on one device —
    # both mesh engines must reproduce it BIT FOR BIT
    s = torch.as_tensor(starts, device=mesh.device)
    e = torch.as_tensor(ends, device=mesh.device)
    rows = build_start_rows(s, e - s + 1, torch.ones_like(s), n, max_span)
    target = capped_coverage(coverage_from_intervals(s, e, n), m)
    zeros = torch.zeros(max_span, dtype=torch.int32, device=mesh.device)
    sel_seq = sweep_counts(rows, target, zeros, zeros, max_span)[0].cpu().numpy()
    assert sel_seq.sum() > 0

    dense, blocked = {}, {}
    sel = solve_on_mesh(mesh, starts, ends, n, m, max_span, stats=dense)
    assert sel.shape == (n,)
    np.testing.assert_array_equal(
        sel, sel_seq,
        err_msg="dense mesh solve diverged from the sequential global sweep",
    )
    sel_b = solve_blocked_on_mesh(mesh, starts, ends, n, m, n_windows_local=2,
                                  block=16, max_span=max_span, stats=blocked)
    np.testing.assert_array_equal(
        sel_b[:n], sel_seq,
        err_msg="blocked mesh solve diverged from the sequential global sweep",
    )
    return {"ranks": n_devices, "max_span": max_span,
            "dense_rounds": dense["rounds"], "blocked_rounds": blocked["rounds"]}
