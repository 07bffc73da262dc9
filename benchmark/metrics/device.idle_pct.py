"""The share of the window (the samples' spans) in which no kernel, copy or
fill ran on the card (``torch.profiler``)."""


def read(run):
    if run.trace is None:
        return None
    window = run.trace.window_s()
    if window <= 0 or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / window)
