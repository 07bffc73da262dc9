"""Exact minimum-read-count solver on the blocked multi-window sweep.

Counterpart of the JAX package's ``solvers/blocked_sweep.py``
(``BlockedWindowedMcpSolver``, its device-reconstruction path). One solve:

1. host C++ pack to the flat uint16 code stream (``_native``);
2. H2D of the stream, the per-group counts and the cross-window offsets;
3. ``expand_flat_codes`` to the padded layout;
4. ``blocked_windowed_sweep``: seed pre-pass + relaxation rounds of kernel B;
5. ``blocked_selection_pass`` (kernel C): a selection byte per packed slot,
   packed to little-endian bits on the device;
6. D2H of the ~R/8-byte bitmask;
7. host C++ bit test (``gd_mask_select``) to read indices.

The selection equals the global sequential sweep's with each end bucket
taken in (start, read index) order, so it is bit-identical to the JAX
solver and to the host greedy.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from genome_downsampler_tpu_torch.core.readbatch import ReadBatch
from genome_downsampler_tpu_torch.solvers.base import Solution, Solver
from genome_downsampler_tpu_torch.utils.logging import get_logger
from genome_downsampler_tpu_torch.utils.profiling import annotate
from genome_downsampler_tpu_torch import _native
from genome_downsampler_tpu_torch.device import resolve_device
from genome_downsampler_tpu_torch.ops.blocked import (
    blocked_selection_pass,
    blocked_windowed_sweep,
    expand_flat_codes,
)
from genome_downsampler_tpu_torch.solvers.device_sweep import DEFAULT_MAX_SPAN

_log = get_logger("torch.solvers.blocked_sweep")


class _Phase:
    """Wall-clock phase laps, each a named profiler region; a lap ends by
    waiting for the device, so it holds the device work queued in it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.laps: dict[str, float] = {}

    @contextlib.contextmanager
    def lap(self, what: str):
        t0 = time.perf_counter()
        with annotate(f"blocked.{what}"):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.laps[what] = time.perf_counter() - t0
        _log.debug("phase %s: %.4fs", what, self.laps[what])


def pack_bits(selbytes: torch.Tensor) -> torch.Tensor:
    """0/1 bytes to little-endian bits (bit i of byte k is slot 8k + i)."""
    shifts = torch.arange(8, dtype=torch.int32, device=selbytes.device)
    flat = selbytes.reshape(-1, 8).to(torch.int32)
    return (flat << shifts).sum(1, dtype=torch.int32).to(torch.uint8)


def _selection_mask(p32, sel, n_windows, block, max_span, win):
    """Argsort engine for the same bucket rule as kernel C, kept as its
    independent cross-check: per end bucket, the first ``sel[e]`` reads by
    (start, slot). Two stable sorts (by start, then by end) give (end,
    start, slot) order; a slot tie-breaks like the read index because equal
    (start, end) reads share a group, filled in index order. Returns
    ``(bits[S // 8] uint8, n_selected)``."""
    W, B, L = n_windows, block, max_span
    nbw, _, cap = p32.shape
    S = nbw * W * cap
    dev = p32.device
    codes = p32.reshape(S).to(torch.int64)
    imax = 2**31 - 1
    valid = codes >= 0
    sidx = torch.arange(S, dtype=torch.int64, device=dev)
    t_idx = sidx // (W * cap)
    w_idx = (sidx // cap) % W
    start = w_idx * win + t_idx * B + codes // L
    end = start + codes % L
    start_key = torch.where(valid, start, imax)
    end_key = torch.where(valid, end, imax)
    o1 = torch.sort(start_key, stable=True).indices
    o = o1[torch.sort(end_key[o1], stable=True).indices]
    e_sorted = end_key[o]
    first = torch.ones(S, dtype=torch.bool, device=dev)
    first[1:] = e_sorted[1:] != e_sorted[:-1]
    first_idx = torch.cummax(torch.where(first, sidx, 0), 0).values
    rank = sidx - first_idx
    quota = sel[e_sorted.clamp(0, sel.shape[0] - 1)]
    take_sorted = (rank < quota) & (e_sorted < imax)
    mask = torch.zeros(S, dtype=torch.uint8, device=dev)
    mask[o] = take_sorted.to(torch.uint8)
    return pack_bits(mask), int(take_sorted.sum())


def _cross_window_offsets(start, end, win, W, B, L) -> np.ndarray:
    """``xwin[w, e']`` = # reads of windows < w ending at window-w-relative
    position ``e'``: their bucket-rank offset (their starts precede every
    window-w start). Only reads within L of a window end qualify."""
    xw = np.zeros((W, B + L), np.int32)
    if len(start) == 0:
        return xw
    w_id = start // win
    spill = np.flatnonzero(end >= (w_id + 1) * win)
    if len(spill):
        rows = w_id[spill] + 1
        np.add.at(xw, (rows, end[spill] - rows * win), 1)
    return xw


class BlockedWindowedMcpSolver(Solver):
    """Exact minimum-read-count solver, O(R) device memory, W windows in
    parallel.

    ``device`` is required: ``"cuda"`` launches the hand-written kernels
    (and raises without a card), ``"cpu"`` runs their plain torch twins.
    The solver never moves from one to the other."""

    uses_quality_of_reads = False

    def __init__(
        self,
        device: str | torch.device,
        n_windows: int | None = None,
        block: int | None = None,
        max_span: int = DEFAULT_MAX_SPAN,
        chunk: int | None = None,
    ):
        self.device = resolve_device(device)
        self.n_windows = n_windows
        self.block = block
        self.max_span = max_span
        self.chunk = chunk
        # filled by solve(): rounds, geometry, phase laps in seconds
        self.last_stats: dict | None = None

    def _geometry(self, n: int, span_max: int, density: float = 0.0):
        """(W, B, L, chunk): the JAX solver's geometry, unchanged, so the
        packed stream and the bitmask are byte-comparable with it. W
        doubles from 8 while each window keeps >= 8 blocks of 256, up to 64
        (32 at >= 150x coverage on >= 1 Mb, where relaxation rounds grow
        with tie density); L grows to a 128-multiple >= span_max + 2 when a
        span reaches it (lane L-1 is reserved); B = 256 only where L is a
        256-multiple and the TPU's selection tile fits its VMEM budget.

        One departure, where the JAX solver raises: W halves (a given
        ``n_windows`` too) until a window is at least L long, since a read
        may cross one window edge but not two (the carries and the
        cross-window offsets hold one)."""
        L = self.max_span
        if span_max >= L:
            L = -(-(span_max + 2) // 128) * 128
        W = self.n_windows
        deep = density >= 150.0 and n >= 1_000_000
        if W is None:
            W = 8
            wcap = 32 if deep else 64
            while W < wcap and n // (2 * W) >= 8 * 256:
                W *= 2

        def block(W):
            return self.block or (
                128
                if (W * 256 * (256 + L) * 4 > 14 * 2**20 or L % 256 != 0)
                else 256
            )

        B = block(W)
        while W > 1 and -(-(-(-n // W)) // B) * B < L:  # the packer's window
            W //= 2
            B = block(W)
        chunk = self.chunk or (128 if B <= 128 else 256)
        return W, B, L, chunk

    def solve(self, max_coverage: int, batch: ReadBatch) -> Solution:
        n = batch.ref_genome_length
        if batch.n_reads == 0:
            return np.zeros(0, np.int64)
        dev = self.device
        ph = _Phase(dev)
        with ph.lap("pack"):
            start = np.asarray(batch.start, np.int64)
            end = np.asarray(batch.end, np.int64)
            span_max = int((end - start).max()) + 1
            # mean span from a 4096-read sample: only the >= 150x rule reads it
            density = float(len(start)) * max(
                float(np.mean((end[:4096] - start[:4096]) + 1)), 1.0
            ) / max(n, 1)
            W, B, L, chunk = self._geometry(n, span_max, density)
            if B * L <= 1 << 16:
                flat, counts, win, _, cap, slots = _native.pack_flat_direct(
                    start, end, n, W, B, L, cap_multiple=chunk, cap_floor=2 * chunk,
                )
                packed = None
            else:
                packed, counts, win, _, slots = _native.pack_blocked(
                    start, end, n, W, B, L, cap_multiple=chunk, cap_floor=2 * chunk,
                )
                cap = packed.shape[2]
            # slots is a C-arena view consumed at the end of the solve
            arena_gen0 = _native.arena_generation()
            xwin = _cross_window_offsets(start, end, win, W, B, L)
            nbw = win // B

        with ph.lap("h2d"):
            # torch.tensor copies, so nothing on the device aliases the arenas
            counts_d = torch.tensor(counts, device=dev)
            xwin_d = torch.tensor(xwin, device=dev)
            if packed is None:
                # uint16 has thin torch support: ship the bits as int16
                codes_d = torch.tensor(flat.view(np.int16), device=dev)
            else:
                codes_d = torch.tensor(packed, device=dev)

        with ph.lap("sweep"):
            p32 = (
                expand_flat_codes(codes_d, counts_d, nbw, W, cap)
                if packed is None else codes_d
            )
            sel, rounds = blocked_windowed_sweep(
                p32, counts_d, None, W, B, L,
                auto_target=True, max_coverage=int(max_coverage),
            )
        with ph.lap("select"):
            selbytes = blocked_selection_pass(p32, counts_d, sel, xwin_d, W, B, L)
            n_selected_d = selbytes.sum(dtype=torch.int64)
            bits_d = pack_bits(selbytes)
        with ph.lap("d2h"):
            bits = bits_d.cpu().numpy()
            n_selected = int(n_selected_d)
        if _native.arena_generation() != arena_gen0:
            raise RuntimeError(
                "native pack arenas were overwritten mid-solve "
                "(interleaved pack call); slots view is stale"
            )
        with ph.lap("bit test"):
            out = _native.mask_select(bits, slots)
        self.last_stats = {
            "rounds": rounds, "n_windows": W, "block": B, "max_span": L,
            "cap": cap, "positions_per_pass": win, "device": str(dev),
            "phases_s": ph.laps,
        }
        if len(out) != n_selected:
            raise RuntimeError(
                f"device mask readback mismatch: {len(out)} != {n_selected}"
            )
        return out
