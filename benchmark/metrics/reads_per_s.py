"""All input reads of the samples completed in the window, over the
window's whole time (a stall inside a sample counts)."""


def read(run):
    return sum(run.reads) / run.window_s if run.reads else None
