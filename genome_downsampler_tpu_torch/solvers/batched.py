"""Batched multi-sample solving: one kernel A launch over all samples.

Counterpart of the JAX package's ``solvers/batched.py``: samples against
the same reference stack into S rows of the dense sweep, each padded to the
longest genome (extra positions carry no reads and a zero target), and
kernel A sweeps them together, one warp per sample.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from genome_downsampler_tpu_torch.core.readbatch import ReadBatch
from genome_downsampler_tpu_torch.device import resolve_device
from genome_downsampler_tpu_torch.ops.sweep import dense_sweep_counts
from genome_downsampler_tpu_torch.solvers.device_sweep import (
    DEFAULT_MAX_SPAN,
    _check_spans,
    _dense_inputs,
    reconstruct_selection,
)


def solve_batch(
    batches: Sequence[ReadBatch],
    max_coverage: int,
    device: str | torch.device,
    max_span: int = DEFAULT_MAX_SPAN,
) -> List[np.ndarray]:
    """Solve several samples (sharing one reference genome) in one sweep
    launch. Returns per-sample selected read indices (each exact)."""
    if not batches:
        return []
    dev = resolve_device(device)
    n = max(b.ref_genome_length for b in batches)
    rows, targets = [], []
    for b in batches:
        if b.n_reads:
            _check_spans(b, max_span)
        target, r = _dense_inputs(b, n, int(max_coverage), max_span, dev)
        rows.append(r)
        targets.append(target)
    zeros = torch.zeros((len(batches), max_span), dtype=torch.int32, device=dev)
    sel, _, _ = dense_sweep_counts(
        torch.cat(rows), torch.cat(targets), zeros, zeros, max_span
    )
    sel = sel.cpu().numpy()
    return [
        reconstruct_selection(
            np.asarray(b.start, np.int64), np.asarray(b.end, np.int64), sel[i]
        )
        for i, b in enumerate(batches)
    ]
