"""Milliseconds of kernel B's device time (``torch.profiler``) a pass: its
launches' summed time (the register path and the wide path) over their
number, over the window. A solve runs a seed pass and one pass a
relaxation round."""

KERNELS = ("blocked_sweep_kernel", "blocked_sweep_wide_kernel")


def read(run):
    if run.trace is None:
        return None
    took = [e - s for n, s, e in run.trace.ops if any(k in n for k in KERNELS)]
    if not took:
        return None
    return sum(took) / len(took) / 1e3
