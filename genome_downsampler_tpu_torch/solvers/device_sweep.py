"""The global sequential water-filling sweep, in torch: the oracle.

Counterpart of ``build_start_rows`` and ``sweep_counts`` in the JAX
package's ``solvers/device_sweep.py`` (the algorithm and its proof are
described there and in ``greedy_mcp.py``). One genome position per step:
fold in the reads starting there, take the deficit against the capped
target from the farthest-ending available reads, emit the selected count
whose reads end here, shift. This is an eager per-position loop, used only
as the reference the blocked kernels are held against at small ``n``.
"""

from __future__ import annotations

import torch

DEFAULT_MAX_SPAN = 256  # static bound on read span (end - start + 1)


def build_start_rows(
    start: torch.Tensor, span: torch.Tensor, weight: torch.Tensor, n: int,
    max_span: int,
) -> torch.Tensor:
    """Dense (n, L) histogram: ``rows[j, k]`` = # reads with start=j,
    span=k+1; ``weight`` is 0 for padded slots."""
    idx = start.to(torch.int64) * max_span + (span.to(torch.int64) - 1)
    idx = idx.clamp(0, n * max_span - 1)
    flat = torch.zeros(n * max_span, dtype=torch.int32, device=start.device)
    flat.index_add_(0, idx, weight.to(torch.int32))
    return flat.reshape(n, max_span)


def sweep_counts(
    add_rows: torch.Tensor,  # int32[n, L]
    target: torch.Tensor,    # int32[n]
    avail0: torch.Tensor,    # int32[L] carry-in, zeros at the genome start
    selend0: torch.Tensor,   # int32[L]
    max_span: int = DEFAULT_MAX_SPAN,
):
    """Run the sweep; returns ``(sel_per_end[n], avail_out[L],
    selend_out[L])``, all int32."""
    L = max_span
    avail = avail0.to(torch.int32).clone()
    selend = selend0.to(torch.int32).clone()
    zero = torch.zeros(1, dtype=torch.int32, device=avail.device)
    out = torch.empty(add_rows.shape[0], dtype=torch.int32, device=avail.device)
    for j in range(add_rows.shape[0]):
        avail = avail + add_rows[j]
        deficit = torch.clamp(target[j] - selend.sum(dtype=torch.int32), min=0)
        # take from the farthest end slots first
        above = torch.flip(
            torch.cumsum(torch.flip(avail, [0]), 0, dtype=torch.int32), [0]
        ) - avail
        take = torch.minimum(torch.clamp(deficit - above, min=0), avail)
        avail = avail - take
        selend = selend + take
        out[j] = selend[0]
        avail = torch.cat([avail[1:L], zero])
        selend = torch.cat([selend[1:L], zero])
    return out, avail, selend
