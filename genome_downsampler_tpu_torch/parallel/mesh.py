"""Multi-process genome-window sharding over ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py`` (its argument for
exactness is in ``parallel/windows.py``): one window per rank of the
``RankMesh``. Each relaxation round every rank sweeps its ``[win, L]``
rows with kernel A (``ops.sweep.dense_sweep_counts``; its plain twin on
the CPU), then sends its carry-out (avail and selend, one ``[2, L]``
message) to rank ``r + 1``; rank 0 receives zeros, the genome-start
boundary. An all-reduce of the "not stable" flag ends the loop, at most
``n_dev`` rounds counted from 1, as in JAX. At the fixed point the union
is bit-identical to the global sequential sweep.

Per round and rank: one kernel A launch, one message of ``8 L`` bytes to
the right (none from the last rank), one 4-byte all-reduce and one host
read of its result; under gloo on the card the carry also crosses to the
host and back (``RankMesh.counters``).
"""

from __future__ import annotations

import numpy as np
import torch

from genome_downsampler_tpu_torch.ops.sweep import dense_sweep_counts
from genome_downsampler_tpu_torch.parallel.launch import RankMesh, shard_rows_globally


def _window_relax_solve(rows_local: torch.Tensor, target_local: torch.Tensor, *,
                        max_span: int, mesh: RankMesh):
    """Per-rank relaxation loop: ``rows_local`` int32 ``[win, L]``,
    ``target_local`` int32 ``[win]`` on ``mesh.device``. Returns
    ``(sel_local[win], rounds)``."""
    L = max_span
    rows, target = rows_local[None], target_local[None]

    def sweep(c_in):  # c_in [2, L]: avail, selend
        sel, a_out, s_out = dense_sweep_counts(rows, target, c_in[0:1], c_in[1:2], L)
        return sel, torch.cat([a_out, s_out])

    c_in = torch.zeros((2, L), dtype=torch.int32, device=rows.device)
    sel, c_out = sweep(c_in)
    k = 1
    while k < mesh.size:
        c_next = mesh.shift_right(c_out)
        if not mesh.any((c_next != c_in).any()):
            break
        c_in = c_next
        sel, c_out = sweep(c_in)
        k += 1
    return sel[0], k


class MeshSolver:
    """The multi-rank dense window solver for genome length ``n`` (a
    multiple of the mesh size): ``solver(rows_local, target_local) ->
    sel_local[win]`` on this rank's window ``[lo, lo + win)``. The JAX
    ``make_mesh_solver``'s jitted function, its shardings replaced by the
    window each rank holds. ``last_stats``: the rounds and the traffic of
    the last call."""

    def __init__(self, mesh: RankMesh, n: int, max_span: int):
        n_dev = mesh.size
        if n % n_dev:
            raise ValueError(f"genome length {n} must be padded to a multiple of {n_dev}")
        win = n // n_dev
        if win < max_span:
            raise ValueError(f"window {win} < max_span {max_span}")
        self.mesh, self.n, self.max_span, self.win = mesh, n, max_span, win
        self.lo = mesh.rank * win
        self.last_stats: dict | None = None

    def __call__(self, rows_local: torch.Tensor, target_local: torch.Tensor):
        before = dict(self.mesh.counters)
        sel, rounds = _window_relax_solve(
            rows_local, target_local, max_span=self.max_span, mesh=self.mesh
        )
        self.last_stats = {"rounds": rounds, "ranks": self.mesh.size, "win": self.win,
                           **{k: v - before[k] for k, v in self.mesh.counters.items()}}
        return sel


def make_mesh_solver(mesh: RankMesh, n: int, max_span: int) -> MeshSolver:
    """The dense mesh solver (JAX ``make_mesh_solver``; the same
    ``ValueError``s)."""
    return MeshSolver(mesh, n, max_span)


def solve_on_mesh(
    mesh: RankMesh,
    start: np.ndarray,
    end: np.ndarray,
    n: int,
    max_coverage: int,
    max_span: int = 256,
    stats: dict | None = None,
) -> np.ndarray:
    """End-to-end mesh solve returning the global per-end selection counts
    (int32 ``[n_pad]``) on every rank, as JAX's ``np.asarray(sel)`` does.
    Each rank builds only its own window's rows from the reads given;
    ``stats``, when given, receives the solver's ``last_stats``."""
    n_dev = mesh.size
    win = max(-(-n // n_dev), max_span)
    fn = make_mesh_solver(mesh, win * n_dev, max_span)
    rows, target = shard_rows_globally(start, end, mesh, win, max_coverage, max_span)
    sel = fn(rows, target)
    if stats is not None:
        stats.update(fn.last_stats)
    return torch.cat(mesh.all_gather(sel)).cpu().numpy()
