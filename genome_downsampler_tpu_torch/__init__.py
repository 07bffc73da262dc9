"""PyTorch / CUDA port of the genome downsampler, for NVIDIA Hopper (H100).

The JAX package ``genome_downsampler_tpu`` is the reference; this package
re-implements its device half in PyTorch with hand-written CUDA kernels and
shares every host-side part that does not import JAX (``ReadBatch``, the
C++ BAM engine and packers in ``_bamio.so``, the host solvers, the
registry and solver base classes, the synthetic-data helpers).

Layer map:

- ``device``    CUDA probe (``require_cuda``) and the card report line
- ``_native``   ctypes bindings to the shared ``_bamio.so`` packers
- ``ops``       coverage ops, the kernel build, the dense sweep (kernel A)
                and the blocked sweep and selection passes (kernels B, C),
                each a CUDA kernel with a plain torch twin
- ``solvers``   ``McpDeviceSweepSolver`` (dense engine, blocked above
                262,144 bases), ``QmcpDeviceSweepSolver``, the blocked
                solver, ``solve_batch``, and the registry (``*-cuda``)
- ``parallel``  ``WindowedMcpSolver``: genome windows as kernel A's rows
- ``cli``       ``python -m genome_downsampler_tpu_torch IN.bam M ...``
- ``entry``     the single-device entry point (the sweep at a small size)

This package never imports ``jax``.
"""

__version__ = "0.1.0"
