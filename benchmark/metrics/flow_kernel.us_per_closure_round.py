"""Microseconds a closure round of the push-relabel kernel, by the kernel's
own global timer (``closure_ns`` over ``closure_rounds`` in
``last_stats``), over the window."""


def read(run):
    stats = [s for s in run.stats if s and s.get("closure_rounds") and "closure_ns" in s]
    if not stats:
        return None
    return sum(s["closure_ns"] for s in stats) / sum(s["closure_rounds"] for s in stats) / 1e3
