"""The distinct reads kept above the fewest that meet the target
(``reference.least_reads``): MCP's count is the least, so the limit is 0."""

from harness import reference


def measure(answer) -> int:
    return int(answer.kept.size) - reference.least_reads(answer.sample, answer.target)
