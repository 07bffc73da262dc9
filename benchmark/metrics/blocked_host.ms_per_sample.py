"""The blocked engine's host laps ``pack`` (the host C++ pack to the code
stream, the cross-window offsets) + ``bit test`` (the selection bits to
read indices) (``last_stats["phases_s"]``) a sample: work done on the
host only."""


def read(run):
    laps = [s["phases_s"] for s in run.stats
            if s and s.get("engine") == "blocked" and "pack" in s.get("phases_s", {})]
    if not laps:
        return None
    return 1e3 * sum(l["pack"] + l["bit test"] for l in laps) / len(laps)
