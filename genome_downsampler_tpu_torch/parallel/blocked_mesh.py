"""Multi-process blocked sweep: O(R/D + n/D) memory per rank.

Counterpart of the JAX package's ``parallel/blocked_mesh.py``, the
chr1-scale path: packed per-(block, window) read codes (kernel B,
``ops.blocked.blocked_sweep_pass``) with genome-axis sharding over the
``RankMesh``.

Global window chain: D ranks x ``W_local`` windows = ``W_total`` windows
over the coordinate line. One Jacobi round = every window sweeps in
parallel from its left neighbour's previous carry-out; the shift is within
the rank for interior windows, and window 0 takes the left rank's last
window over the wire (one ``[2, L]`` message a round; zeros at rank 0). An
all-reduced stability flag ends the loop, at most ``n_dev * W_local``
rounds; the fixed point is bit-identical to the global sequential sweep.
As in JAX there is no seed pre-pass (the single-process
``blocked_windowed_sweep`` has one).

Targets are given, so kernel B's third carry (``avail0i``, the untaken
ring that only ``auto_target`` reads) stays zero. The TPU-only knobs of the
JAX solver (``chunk``, ``interpret``, ``static_chunks``) have no
counterpart.
"""

from __future__ import annotations

import torch

from genome_downsampler_tpu_torch.ops.blocked import blocked_sweep_pass
from genome_downsampler_tpu_torch.parallel.launch import RankMesh


def _blocked_relax_local(
    packed_local: torch.Tensor,   # int32[nbw, W_local, cap]
    counts_local: torch.Tensor,   # int32[nbw, W_local]
    target_local: torch.Tensor,   # int32[W_local, win]
    *,
    n_windows_local: int,
    block: int,
    max_span: int,
    mesh: RankMesh,
):
    """Per-rank joint relaxation of the global window chain, the local
    windows advancing together each round. Returns ``(sel[W_local, win],
    rounds)``."""
    W, L = n_windows_local, max_span
    total_rounds = mesh.size * W

    def passes(c_in):  # c_in [2, W, L]: avail, selend
        sel, a_out, s_out, _ = blocked_sweep_pass(
            packed_local, counts_local, target_local, c_in[0], c_in[1], W, block, L
        )
        return sel, torch.stack([a_out, s_out])

    def shift(c_out):
        # window w takes w-1's carry; window 0 the left rank's last window
        from_left = mesh.shift_right(c_out[:, -1].contiguous())
        return torch.cat([from_left[:, None], c_out[:, :-1]], dim=1)

    c_in = torch.zeros((2, W, L), dtype=torch.int32, device=packed_local.device)
    sel, c_out = passes(c_in)
    k = 1
    while k < total_rounds:
        c_next = shift(c_out)
        if not mesh.any((c_next != c_in).any()):
            break
        c_in = c_next
        sel, c_out = passes(c_in)
        k += 1
    return sel, k


class BlockedMeshSolver:
    """``solver(packed, counts, target) -> sel[W_local, win]`` for this
    rank's windows ``[r * W_local, (r + 1) * W_local)`` of the chain,
    inputs on ``mesh.device`` as ``pack_blocked`` lays them out for the
    rank's own span (``nbw`` blocks, ``cap`` slots). ``last_stats``: the
    rounds (one kernel B pass each) and the traffic of the last call."""

    def __init__(self, mesh: RankMesh, nbw: int, cap: int, win: int,
                 n_windows_local: int, block: int, max_span: int):
        self.mesh, self.nbw, self.cap, self.win = mesh, nbw, cap, win
        self.n_windows_local, self.block, self.max_span = n_windows_local, block, max_span
        self.last_stats: dict | None = None

    def __call__(self, packed, counts, target):
        W = self.n_windows_local
        for name, x, shape in (("packed", packed, (self.nbw, W, self.cap)),
                               ("counts", counts, (self.nbw, W)),
                               ("target", target, (W, self.win))):
            if tuple(x.shape) != shape:
                raise ValueError(f"{name}: expected {list(shape)}, got {list(x.shape)}")
        before = dict(self.mesh.counters)
        sel, rounds = _blocked_relax_local(
            packed, counts, target, n_windows_local=W, block=self.block,
            max_span=self.max_span, mesh=self.mesh,
        )
        self.last_stats = {"rounds": rounds, "ranks": self.mesh.size,
                           "windows_local": W, "win": self.win,
                           **{k: v - before[k] for k, v in self.mesh.counters.items()}}
        return sel


def make_blocked_mesh_solver(
    mesh: RankMesh,
    nbw: int,
    cap: int,
    win: int,
    n_windows_local: int = 8,
    block: int = 256,
    max_span: int = 256,
) -> BlockedMeshSolver:
    """The multi-rank blocked solver (JAX ``make_blocked_mesh_solver``):
    for codes packed by ``pack_blocked`` over ``W_total = mesh.size *
    n_windows_local`` windows of ``win`` positions, each rank given its
    own ``n_windows_local`` of them."""
    return BlockedMeshSolver(mesh, nbw, cap, win, n_windows_local, block, max_span)
