"""Coverage ops in torch: scatter-diff + prefix sum.

Counterpart of the JAX package's ``ops/coverage.py``: a difference array
(+w at ``start``, -w at ``end + 1``) summed by ``cumsum``, O(reads +
genome). Runs on whatever device its inputs lie on.
"""

from __future__ import annotations

import torch


def coverage_from_intervals(
    start: torch.Tensor,
    end: torch.Tensor,
    genome_length: int,
    weight: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-base coverage int32[genome_length] of inclusive ``[start, end]``
    intervals; ``weight`` (default 1) masks padded or unselected reads.
    Indices beyond the genome are dropped, as in the JAX version."""
    n = int(genome_length)
    dev = start.device
    w = (
        torch.ones(start.shape, dtype=torch.int32, device=dev)
        if weight is None else weight.to(torch.int32)
    )
    s = start.to(torch.int64).clamp(0, n)
    e1 = (end.to(torch.int64) + 1).clamp(0, n)
    # one spare slot at index n absorbs the clipped (dropped) updates
    diff = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    diff.index_add_(0, s, w)
    diff.index_add_(0, e1, -w)
    return torch.cumsum(diff, 0, dtype=torch.int32)[:n]


def capped_coverage(coverage: torch.Tensor, max_coverage: int) -> torch.Tensor:
    """``min(input_coverage, M)``: the per-base selection target."""
    return torch.clamp(coverage, max=int(max_coverage))


def demand_from_capped(capped: torch.Tensor) -> torch.Tensor:
    """Node demands ``d[i] = b[i] - b[i+1]`` over nodes ``0..n`` of the
    interval-flow network, with ``b = [0, capped..., 0]``; they sum to zero
    (the reference's ``create_demand_function``)."""
    z = capped.new_zeros(1)
    b = torch.cat([z, capped, z])
    return b[:-1] - b[1:]


def coverage_is_valid(
    input_coverage: torch.Tensor, output_coverage: torch.Tensor, max_coverage: int
) -> bool:
    """``min(input_cov, M) <= output_cov`` at every base."""
    capped = capped_coverage(input_coverage, max_coverage)
    return bool(torch.all(capped <= output_coverage))
