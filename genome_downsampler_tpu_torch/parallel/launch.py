"""Multi-process runtime: ``torch.distributed`` bootstrap, the rank mesh and
per-rank data placement.

Counterpart of the JAX package's ``parallel/launch.py``. There a process
joins ``jax.distributed`` and the job's devices form one 1-D mesh; here
each process is one rank on one device, and the ranks in order are the
mesh (``RankMesh``): rank ``r`` holds genome window range ``r``.

Environment contract (the JAX package's):
    GD_COORDINATOR   host:port of process 0      (default 127.0.0.1:9911)
    GD_NUM_PROCESSES world size                  (default 1)
    GD_PROCESS_ID    this process's rank         (default 0)
and, for the card a rank takes and the backend rule, torchrun's
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` (default: one host, so the rank
and the world size).

Backend rule (``default_backend``): ``gloo`` on the CPU; on CUDA ``nccl``
where every rank of a host has a card of its own, else ``gloo``, whose
ranks may share a card (local rank ``r`` takes card ``r % cards``). NCCL
refuses two ranks on one card. Nothing switches backends on its own: a
caller that names ``nccl`` where it cannot work gets NCCL's error. The
kernels run on the named device whatever the backend; under gloo the
tensors a collective ships are copied to the host and back explicitly,
and ``RankMesh.counters`` counts those bytes and the host syncs.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from genome_downsampler_tpu_torch.device import resolve_device
from genome_downsampler_tpu_torch.ops.coverage import (
    capped_coverage,
    coverage_from_intervals,
)
from genome_downsampler_tpu_torch.solvers.device_sweep import build_start_rows
from genome_downsampler_tpu_torch.utils.logging import get_logger

_log = get_logger("parallel.launch")


def _local_ranks(num_processes: int) -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))


def _local_rank(process_id: int) -> int:
    return int(os.environ.get("LOCAL_RANK", process_id))


def default_backend(device: str | torch.device, local_processes: int) -> str:
    """``gloo`` on the CPU; on CUDA ``nccl`` while the host's ranks are no
    more than its cards, else ``gloo``."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if local_processes <= torch.cuda.device_count() else "gloo"


def initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> bool:
    """Start the default process group from the arguments or the GD_*
    environment; ``backend`` defaults to ``default_backend``'s rule.

    One process joins through an in-memory store (no port is opened); more
    rendezvous at ``tcp://<coordinator>``. Returns True if the group was
    started here (the caller destroys it), False if one was already up."""
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    coordinator = coordinator or os.environ.get("GD_COORDINATOR", "127.0.0.1:9911")
    num_processes = int(
        num_processes
        if num_processes is not None
        else os.environ.get("GD_NUM_PROCESSES", "1")
    )
    process_id = int(
        process_id if process_id is not None else os.environ.get("GD_PROCESS_ID", "0")
    )
    local = _local_ranks(num_processes)
    rule = "asked" if backend else (
        "rule: gloo on the CPU; on CUDA nccl while ranks per host "
        f"({local}) <= cards ({torch.cuda.device_count()}), else gloo"
    )
    backend = backend or default_backend(dev, local)
    if dev.type == "cuda":
        torch.cuda.set_device(_local_rank(process_id) % torch.cuda.device_count())
    _log.info("torch.distributed: rank %d of %d on %s, backend %s (%s)",
              process_id, num_processes, dev.type, backend, rule)
    if num_processes == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}", rank=process_id,
            world_size=num_processes,
        )
    return True


class RankMesh:
    """The world's ranks in order along the genome: the JAX package's 1-D
    ``("x",)`` mesh with one device per process.

    ``device`` is where this rank's kernels run; ``wire`` where the
    tensors of a collective lie: the card under nccl, the host otherwise.
    Without a process group the mesh is one rank that ships nothing.
    ``counters`` accumulate ``messages`` and ``wire_bytes`` sent by this
    rank, ``host_copy_bytes`` moved between the card and the host for the
    wire, and ``host_syncs`` (reads of a device value on the host)."""

    def __init__(self, device: torch.device):
        self.device = device
        if dist.is_initialized():
            self.rank, self.size = dist.get_rank(), dist.get_world_size()
            self.backend = dist.get_backend()
        else:
            self.rank, self.size, self.backend = 0, 1, None
        self.wire = device if self.backend == "nccl" else torch.device("cpu")
        self.counters = dict(messages=0, wire_bytes=0, host_copy_bytes=0,
                             host_syncs=0)

    def _to_wire(self, x: torch.Tensor) -> torch.Tensor:
        if x.device == self.wire:
            return x.contiguous()
        self.counters["host_copy_bytes"] += x.numel() * x.element_size()
        if x.device.type == "cuda":
            self.counters["host_syncs"] += 1
        return x.to(self.wire)

    def _from_wire(self, x: torch.Tensor) -> torch.Tensor:
        if x.device != self.device:
            self.counters["host_copy_bytes"] += x.numel() * x.element_size()
        return x.to(self.device)

    def shift_right(self, x: torch.Tensor) -> torch.Tensor:
        """Send ``x`` to rank ``r + 1`` and return rank ``r - 1``'s: zeros
        at rank 0, the genome start (``ppermute`` over ``i -> i + 1``)."""
        if self.size == 1:
            return torch.zeros_like(x)
        works, recv = [], None
        if self.rank + 1 < self.size:
            send = self._to_wire(x)
            works.append(dist.isend(send, self.rank + 1))
            self.counters["messages"] += 1
            self.counters["wire_bytes"] += send.numel() * send.element_size()
        if self.rank > 0:
            recv = torch.empty(x.shape, dtype=x.dtype, device=self.wire)
            works.append(dist.irecv(recv, self.rank - 1))
        for w in works:
            w.wait()
        return torch.zeros_like(x) if recv is None else self._from_wire(recv)

    def any(self, flag: torch.Tensor) -> bool:
        """Whether ``flag`` (a bool scalar) holds on any rank: one
        all-reduce (``psum``) and one host read."""
        x = flag
        if self.backend is not None:
            x = self._to_wire(flag.to(torch.int32).reshape(1))
            dist.all_reduce(x)
            self.counters["messages"] += 1
            self.counters["wire_bytes"] += 4
        if x.device.type == "cuda":
            self.counters["host_syncs"] += 1
        return bool(x)

    def all_gather(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``x`` (one shape on all ranks), in rank order, on
        the wire's device."""
        x = self._to_wire(x)
        if self.backend is None:
            return [x]
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x)
        self.counters["messages"] += 1
        self.counters["wire_bytes"] += x.numel() * x.element_size()
        return parts


def global_window_mesh(device: str | torch.device = "cuda") -> RankMesh:
    """The world's ranks as one mesh over the genome, this rank on
    ``device``; a bare ``"cuda"`` names the card of this rank's local
    rank (modulo the cards: ranks beyond them share, under gloo)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", _local_rank(rank) % torch.cuda.device_count())
    return RankMesh(dev)


def shard_rows_globally(start, end, mesh: RankMesh, win: int, max_coverage: int,
                        max_span: int):
    """This rank's dense inputs on ``mesh.device``: ``rows`` int32
    ``[win, L]``, the arrival histogram of the reads starting in its window
    ``[r * win, (r + 1) * win)``, and ``target`` int32 ``[win]``, the
    capped coverage there of every read given. Reads outside the window
    add nothing, so a rank may pass only the reads near its window and no
    rank builds the whole genome."""
    lo = mesh.rank * win
    s = torch.as_tensor(np.asarray(start, np.int64), device=mesh.device) - lo
    e = torch.as_tensor(np.asarray(end, np.int64), device=mesh.device) - lo
    own = (s >= 0) & (s < win)
    span = e - s + 1
    if bool((own & (span > max_span)).any()):
        raise ValueError(
            f"read span {int(span[own].max())} exceeds max_span={max_span}"
        )
    rows = build_start_rows(s, span, own, win, max_span)
    target = capped_coverage(coverage_from_intervals(s, e, win), max_coverage)
    return rows, target.contiguous()
