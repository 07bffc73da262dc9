"""The fewest reads that meet the target, chosen with no regard to quality:
it breaks QMCP's guarantee of the least ``sum(max_q - q + 1)``
(``checks/cost_gap.py``)."""

from harness import reference


def select(sample, m):
    return reference.least_selection(sample, reference.target(sample, m))
