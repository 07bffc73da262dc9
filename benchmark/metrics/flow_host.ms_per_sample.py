"""The flow solver's host laps ``coverage`` + ``arcs`` + ``select``
(``last_stats["laps_s"]``) a sample: host time outside the kernel's
launch and read (``arcs`` and ``coverage`` queue work without waiting for
it)."""


def read(run):
    laps = [s["laps_s"] for s in run.stats if s and "laps_s" in s]
    if not laps:
        return None
    return 1e3 * sum(l["coverage"] + l["arcs"] + l["select"] for l in laps) / len(laps)
