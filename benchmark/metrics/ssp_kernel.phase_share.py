"""The share of the SSP kernel's time outside its fixpoint rounds, by the
kernel's own global timer: each phase's reset and bucket tables
(``tables_ns``) and its end (argmin, walk, push, potentials and supply:
``phase_end_ns``) over those and the rounds (``rounds_ns``), thread 0 of
CTA 0's laps in ``last_stats``, summed over the window."""

LAPS = ("rounds_ns", "tables_ns", "phase_end_ns")


def read(run):
    stats = [s for s in run.stats if s and all(k in s for k in LAPS)]
    total = sum(s[k] for s in stats for k in LAPS)
    if not total:
        return None
    return 100.0 * sum(s["tables_ns"] + s["phase_end_ns"] for s in stats) / total
