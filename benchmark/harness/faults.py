"""Faults planted under the timed path of a real run, for setting and
testing the limits (``tools/readings.py``, ``tests/``); the benchmark's own
runs plant none. The controls, which put a selection in the program's
place, are files of their own (``controls/<name>.py``).

- ``unchanged``: the solve's flow left as it started, so no read carries
  it and none is selected;
- ``half_batch``: the solve sees only the first half of the reads;
- ``altered``: every hundredth read index dropped where the answer is
  produced.
"""

from __future__ import annotations

import numpy as np

FAULTS = ("unchanged", "half_batch", "altered")


class Faulty:
    """``solver`` with ``fault`` planted under its ``solve``."""

    def __init__(self, solver, fault: str):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
        self.solver = solver
        self.fault = fault
        self.inner = getattr(solver, "inner", solver)

    def solve(self, max_coverage: int, batch) -> np.ndarray:
        if self.fault == "unchanged":
            return np.empty(0, np.int64)
        if self.fault == "half_batch":
            return self.solver.solve(max_coverage, batch.select(np.arange(batch.n_reads // 2)))
        sel = np.asarray(self.solver.solve(max_coverage, batch))
        return np.delete(sel, np.s_[::100])
