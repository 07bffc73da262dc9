"""Genome-window parallelism for the dense sweep on one card.

Counterpart of the JAX package's ``parallel/windows.py`` (the argument for
its exactness is there). The genome is cut into W windows, which kernel A
sweeps together as W rows. Round 0 starts every window from zero carries;
each later round seeds window ``w`` with window ``w - 1``'s carry-out of
the round before, until the shifted carry-outs equal the carry-ins or W
rounds have run. Window 0 is exact from round 0, so after round ``k`` the
first ``k + 1`` windows are, and the stable result is bit-identical to the
global sequential sweep.
"""

from __future__ import annotations

import numpy as np
import torch

from genome_downsampler_tpu_torch.core.readbatch import ReadBatch
from genome_downsampler_tpu_torch.solvers.base import Solution, Solver
from genome_downsampler_tpu_torch.device import resolve_device
from genome_downsampler_tpu_torch.ops.sweep import dense_sweep_counts
from genome_downsampler_tpu_torch.solvers.device_sweep import (
    DEFAULT_MAX_SPAN,
    _check_spans,
    _dense_inputs,
    reconstruct_selection,
)


def windowed_sweep_counts(rows, target, n_windows: int, win: int,
                          max_span: int):
    """Exact global sweep by carry relaxation over W windows.

    ``rows`` int32 ``[W * win, L]``, ``target`` int32 ``[W * win]``.
    Returns ``(sel_per_end[W * win], rounds)``: the same counts as one
    sweep over the whole genome, and the number of kernel A launches
    (``rounds`` counts from 1, as the JAX loop's ``k`` does)."""
    W, L = n_windows, max_span
    rows_w = rows.reshape(W, win, L)
    target_w = target.reshape(W, win)
    zeros = torch.zeros((W, L), dtype=torch.int32, device=rows.device)

    def shift(c_out):
        return torch.cat([zeros[:1], c_out[:-1]])

    sel, a_out, s_out = dense_sweep_counts(rows_w, target_w, zeros, zeros, L)
    a_in, s_in, k = zeros, zeros, 1
    while k < W:
        a_nx, s_nx = shift(a_out), shift(s_out)
        if torch.equal(a_nx, a_in) and torch.equal(s_nx, s_in):
            break
        a_in, s_in = a_nx, s_nx
        sel, a_out, s_out = dense_sweep_counts(rows_w, target_w, a_in, s_in, L)
        k += 1
    return sel.reshape(W * win), k


class WindowedMcpSolver(Solver):
    """Exact MCP with W-way window parallelism (the CLI's ``--windows``);
    the same selection as the global sweep and the host greedy.

    ``device`` is required: ``"cuda"`` launches kernel A (and raises
    without a card), ``"cpu"`` runs its plain twin."""

    uses_quality_of_reads = False

    def __init__(
        self,
        device: str | torch.device,
        n_windows: int = 8,
        max_span: int = DEFAULT_MAX_SPAN,
    ):
        self.device = resolve_device(device)
        self.n_windows = n_windows
        self.max_span = max_span
        # filled by solve(): relaxation rounds and the window geometry
        self.last_stats: dict | None = None

    def solve(self, max_coverage: int, batch: ReadBatch) -> Solution:
        n = batch.ref_genome_length
        if batch.n_reads == 0:
            return np.zeros(0, np.int64)
        _check_spans(batch, self.max_span)
        W = self.n_windows
        win = -(-n // W)
        if win < self.max_span:
            raise ValueError(
                f"window length {win} must be >= max_span={self.max_span}; "
                "use fewer windows"
            )
        target, rows = _dense_inputs(
            batch, W * win, int(max_coverage), self.max_span, self.device
        )
        sel_per_end, rounds = windowed_sweep_counts(
            rows[0], target[0], W, win, self.max_span
        )
        self.last_stats = {"rounds": rounds, "n_windows": W, "win": win}
        return reconstruct_selection(
            np.asarray(batch.start, np.int64),
            np.asarray(batch.end, np.int64),
            sel_per_end.cpu().numpy(),
        )
