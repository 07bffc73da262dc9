"""Selected indices that name no read of the sample, or name one twice.
Exact: the limit is 0."""


def measure(answer) -> int:
    return int(answer.selection.size - answer.kept.size)
