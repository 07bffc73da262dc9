"""``qmcp-cuda``'s host laps ``buckets`` + ``select``
(``last_stats["phases_s"]``) a sample: work done on the host only."""


def read(run):
    laps = [s["phases_s"] for s in run.stats if s and "buckets" in s.get("phases_s", {})]
    if not laps:
        return None
    return 1e3 * sum(l["buckets"] + l["select"] for l in laps) / len(laps)
