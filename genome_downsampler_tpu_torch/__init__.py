"""PyTorch / CUDA port of the genome downsampler, for NVIDIA Hopper (H100).

The JAX package ``genome_downsampler_tpu`` is the reference; this package
re-implements its device half in PyTorch with hand-written CUDA kernels and
keeps its own copy of every host-side part (``ReadBatch``, the C++ BAM
engine, packers, host greedy and MCMF, the host solvers, the registry and
solver base classes, the synthetic-data helpers). It imports nothing of
the JAX package.

Layer map:

- ``core``, ``config``, ``utils``  ``ReadBatch``, the BAM filter config,
                logging and timers
- ``io``        BAM / BAI / BED / TSV over the C++ host library
                (``io/csrc``, built with g++ into ``build/gd_host/``)
- ``testing``   read generators, BAM writer, coverage tester
- ``device``    CUDA probe (``require_cuda``) and the card report line
- ``_native``   ctypes bindings to the host library's packers
- ``ops``       coverage ops, the kernel build, the dense sweep (kernel A)
                and the blocked sweep and selection passes (kernels B, C),
                each a CUDA kernel with a plain torch twin
- ``solvers``   ``McpDeviceSweepSolver`` (dense engine, blocked above
                262,144 bases), ``QmcpDeviceSweepSolver``, the blocked
                solver, ``solve_batch``, the host solvers and the registry
                (``*-cpu``, ``*-cuda``)
- ``parallel``  ``WindowedMcpSolver``: genome windows as kernel A's rows
- ``cli``       ``python -m genome_downsampler_tpu_torch IN.bam M ...``
- ``entry``     the single-device entry point (the sweep at a small size)

This package never imports ``jax``.
"""

__version__ = "0.1.0"
