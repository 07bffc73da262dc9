"""A max flow stopped with 300 units of demand unmet: the fewest reads that
meet the target, with 300 of them (spread evenly by index) dropped. The
reference's CUDA push-relabel ends its global relabels once 300 units of
excess are left and finishes with a last loop; this is that loop skipped.
Each read of a least-count selection is needed somewhere, so it breaks the
coverage guarantee (``checks/deficit_bases.py``)."""

import numpy as np

from harness import reference

UNMET = 300


def select(sample, m):
    least = reference.least_selection(sample, reference.target(sample, m))
    drop = np.unique(np.linspace(0, len(least) - 1, min(UNMET, len(least))).astype(np.int64))
    return np.delete(least, drop)
