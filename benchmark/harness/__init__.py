"""The port's benchmark harness (``benchmark/run.py``): the cell's parts found by
name, the sample generator, the window, the trace reading and the plain
reference that decides ``correct``. It imports nothing of the JAX package."""
