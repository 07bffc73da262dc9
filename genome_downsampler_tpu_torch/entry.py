"""Single-device entry point: the flagship sweep on one device.

Torch form of the JAX package's ``__graft_entry__.entry``: returns
``(fn, example_args)`` such that ``fn(*example_args)`` runs the dense
water-filling sweep (``ops.sweep.dense_sweep_counts``, kernel A on a CUDA
device, its plain twin on the CPU) at n = 1024 positions, L = 128, on the
named device. The inputs are those of the JAX entry (the same numpy seed),
so the two results are comparable.
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
