"""Name -> solver registry of the port.

Built on the JAX package's jax-free ``SolverRegistry`` and host factories:
the CPU names are the same solvers as there. The accelerator names are
``*-cuda``: ``quasi-mcp-cuda`` is the reference's own name for its
accelerator solver; ``mcp-cuda``, ``mcp-cuda-blocked`` and
``qmcp-sweep-cuda`` mirror ``mcp-tpu``, ``mcp-tpu-blocked`` and
``qmcp-sweep-tpu``. ``mcp-cuda`` and ``quasi-mcp-cuda`` run the dense
engine up to 262,144 bases and the blocked engine above, and refuse reads
longer than 256 bases; ``mcp-cuda-blocked`` always runs the blocked engine,
which grows its span bound for longer reads. Constructing any of them
without a card raises.
"""

from __future__ import annotations

from genome_downsampler_tpu.solvers.base import Solver
from genome_downsampler_tpu.solvers.registry import (
    DEFAULT_SOLVER_NAME,
    SolverRegistry,
    _make_greedy,
    _make_py_greedy,
    _make_qmcp_cpu,
    _make_qmcp_lp,
    _make_test,
)

__all__ = ["DEFAULT_SOLVER_NAME", "default_registry"]


def _make_mcp_cuda() -> Solver:
    from genome_downsampler_tpu_torch.solvers.device_sweep import (
        McpDeviceSweepSolver,
    )

    return McpDeviceSweepSolver(device="cuda")


def _make_mcp_cuda_blocked() -> Solver:
    from genome_downsampler_tpu_torch.solvers.blocked_sweep import (
        BlockedWindowedMcpSolver,
    )

    return BlockedWindowedMcpSolver(device="cuda")


def _make_qmcp_sweep_cuda() -> Solver:
    from genome_downsampler_tpu_torch.solvers.device_sweep import (
        QmcpDeviceSweepSolver,
    )

    return QmcpDeviceSweepSolver(device="cuda")


def default_registry() -> SolverRegistry:
    reg = SolverRegistry()
    reg.register("quasi-mcp-cpu", _make_greedy, uses_quality=False)
    reg.register("mcp-cpu", _make_greedy, uses_quality=False)
    reg.register("mcp-cpu-py", _make_py_greedy, uses_quality=False)
    reg.register("qmcp-cpu", _make_qmcp_cpu, uses_quality=True)
    reg.register("qmcp-lp-cpu", _make_qmcp_lp, uses_quality=True)
    # the exact sweep is also the best feasible selection, so the quasi
    # name maps to it (as quasi-mcp-tpu does in the JAX package)
    reg.register("quasi-mcp-cuda", _make_mcp_cuda, uses_quality=False)
    reg.register("mcp-cuda", _make_mcp_cuda, uses_quality=False)
    reg.register("mcp-cuda-blocked", _make_mcp_cuda_blocked, uses_quality=False)
    # minimum count, then identities by quality from the sweep's takes
    reg.register("qmcp-sweep-cuda", _make_qmcp_sweep_cuda, uses_quality=True)
    reg.register("test", _make_test, uses_quality=False)
    return reg
