"""Microseconds a superstep of the push-relabel kernel, by the kernel's own
global timer (``superstep_ns`` over ``supersteps`` in ``last_stats``),
over the window."""


def read(run):
    stats = [s for s in run.stats if s and s.get("supersteps") and "superstep_ns" in s]
    if not stats:
        return None
    return sum(s["superstep_ns"] for s in stats) / sum(s["supersteps"] for s in stats) / 1e3
