"""Microseconds of SSP kernel device time (``torch.profiler``) a fixpoint
round (``last_stats["rounds"]``), over the window."""

KERNEL = "ssp_kernel"


def read(run):
    if run.trace is None:
        return None
    rounds = sum(s.get("rounds", 0) for s in run.stats if s)
    took = run.trace.op_seconds(KERNEL)
    if not rounds or not took:
        return None
    return 1e6 * took / rounds
