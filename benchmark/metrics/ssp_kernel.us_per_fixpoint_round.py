"""Microseconds a fixpoint round of the SSP kernel, by the kernel's own
global timer: the rounds' lap (``rounds_ns``) over ``rounds`` in
``last_stats``, over the window; the phases' tables and ends are left
out (``ssp_kernel.phase_share``)."""


def read(run):
    stats = [s for s in run.stats if s and s.get("rounds") and "rounds_ns" in s]
    if not stats:
        return None
    return sum(s["rounds_ns"] for s in stats) / sum(s["rounds"] for s in stats) / 1e3
