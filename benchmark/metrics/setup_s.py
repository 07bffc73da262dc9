"""Process start to the window: the torch import, the CUDA context, the
kernel library's build (a first run only) and load, and one warm solve."""


def read(run):
    return run.setup_s
