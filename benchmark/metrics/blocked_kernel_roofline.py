"""The blocked engine's kernels' share of their roofline: the least time
the card needs to read each read's start and end and each base's target
and write one bit a read (``harness/roofline.py``), over the device time
of the kernels that make the selection (kernel B's passes, register and
wide path, and kernel C) under ``torch.profiler``, summed over the
window's blocked solves."""

from harness import roofline

KERNELS = ("blocked_sweep_kernel", "blocked_sweep_wide_kernel", "blocked_select_kernel",
           "blocked_select_hash_kernel")
FIELD_BYTES = 8  # start, end: int32


def read(run):
    if run.trace is None:
        return None
    took = sum(e - s for n, s, e in run.trace.ops if any(k in n for k in KERNELS)) / 1e6
    least = roofline.least_seconds(run.kind, sum(
        roofline.selection_bytes(r, n, FIELD_BYTES)
        for r, n, s in zip(run.reads, run.genome, run.stats) if s and s.get("engine") == "blocked"))
    if not took or not least:
        return None
    return 100.0 * least / took
