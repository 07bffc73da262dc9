"""The fewest reads that meet the target, and 300 reads more from outside
them, spread evenly by index: coverage is kept, and MCP's guarantee of the
least count is broken (``checks/count_gap.py``)."""

import numpy as np

from harness import reference

EXTRA = 300


def select(sample, m):
    least = reference.least_selection(sample, reference.target(sample, m))
    rest = np.setdiff1d(np.arange(len(sample["start"])), least)
    pick = np.unique(np.linspace(0, len(rest) - 1, min(EXTRA, len(rest))).astype(np.int64))
    return np.sort(np.concatenate([least, rest[pick]]))
