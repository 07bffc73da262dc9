"""Bases where the selection's coverage falls below ``min(coverage in, M)``:
the guarantee every solver gives. Exact: the limit is 0."""


def measure(answer) -> int:
    return int((answer.coverage_out < answer.target).sum())
