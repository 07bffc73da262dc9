"""The share of the push-relabel kernel's time in its global relabels (the
distance closures), by the kernel's own global timer: ``closure_ns`` over
``closure_ns + superstep_ns`` (CTA 0's laps in ``last_stats``), summed over
the window."""


def read(run):
    stats = [s for s in run.stats if s and "closure_ns" in s and "superstep_ns" in s]
    total = sum(s["closure_ns"] + s["superstep_ns"] for s in stats)
    if not total:
        return None
    return 100.0 * sum(s["closure_ns"] for s in stats) / total
