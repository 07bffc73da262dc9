"""The selection's ``sum(max_q - q + 1)`` above the least the target
allows: QMCP's optimum is exact, so the limit is 0."""


def measure(answer) -> int:
    return answer.cost - answer.least_cost
