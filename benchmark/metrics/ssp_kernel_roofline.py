"""The SSP kernel's share of its roofline: the least time the card needs to
read each read's start, end and quality and each base's target and write
one bit a read (``harness/roofline.py``), over the kernel's device time
under ``torch.profiler``, summed over the window."""

from harness import roofline

KERNEL = "ssp_kernel"
FIELD_BYTES = 12  # start, end, quality: int32


def read(run):
    if run.trace is None:
        return None
    took = run.trace.op_seconds(KERNEL)
    least = roofline.least_seconds(run.kind, sum(
        roofline.selection_bytes(r, n, FIELD_BYTES) for r, n in zip(run.reads, run.genome)))
    if not took or least is None:
        return None
    return 100.0 * least / took
