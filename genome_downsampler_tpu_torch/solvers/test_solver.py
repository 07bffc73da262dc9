"""Identity solver — fake backend for plumbing tests.

Parity: ``qmcp::TestSolver``
(``reference/libs/qmcp-solver/src/test_solver.cpp:10-22``) returns all
read indices unchanged.
"""

from __future__ import annotations

import numpy as np

from genome_downsampler_tpu_torch.core.readbatch import ReadBatch
from genome_downsampler_tpu_torch.solvers.base import Solution, Solver


class TestSolver(Solver):
    uses_quality_of_reads = False

    def solve(self, max_coverage: int, batch: ReadBatch) -> Solution:
        return np.arange(batch.n_reads, dtype=np.int64)
