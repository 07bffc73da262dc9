"""Name -> solver registry of the port.

The registry class and the CPU names are the JAX package's
(``solvers/registry.py``), copied here with the host solvers they build.
The accelerator names are ``*-cuda``: ``quasi-mcp-cuda`` is the
reference's own name for its accelerator solver; ``mcp-cuda``,
``mcp-cuda-blocked``, ``qmcp-sweep-cuda``, ``qmcp-cuda`` and
``quasi-mcp-flow-cuda`` mirror ``mcp-tpu``, ``mcp-tpu-blocked``,
``qmcp-sweep-tpu``, ``qmcp-tpu`` and ``quasi-mcp-flow-tpu`` (the
deterministic push-relabel flow engine, one push-relabel kernel launch a
solve). ``mcp-cuda`` and
``quasi-mcp-cuda`` run the dense engine up to 262,144 bases and the blocked
engine above, and refuse reads longer than 256 bases; ``mcp-cuda-blocked``
always runs the blocked engine, which grows its span bound L with the
longest read and takes any read its int32 codes carry (block * L < 2^31).
Constructing any of them without a card raises. Factories are lazy,
so importing the registry loads no solver module.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from genome_downsampler_tpu_torch.solvers.base import Solver, SpanGuard

DEFAULT_SOLVER_NAME = "quasi-mcp-cpu"  # the reference's default

__all__ = ["DEFAULT_SOLVER_NAME", "SolverRegistry", "default_registry"]


class SolverRegistry:
    def __init__(self) -> None:
        self._factories: Dict[str, Callable[[], Solver]] = {}
        self._uses_quality: Dict[str, bool] = {}

    def register(
        self, name: str, factory: Callable[[], Solver], uses_quality: bool
    ) -> None:
        self._factories[name] = factory
        self._uses_quality[name] = uses_quality

    def contains(self, name: str) -> bool:
        return name in self._factories

    def get(self, name: str) -> Solver:
        """A new solver of that name, behind ``SpanGuard``."""
        if name not in self._factories:
            raise KeyError(f"unknown solver: {name!r}; known: {self.get_names()}")
        return SpanGuard(self._factories[name]())

    def uses_quality_of_reads(self, name: str) -> bool:
        """Static lookup (no instantiation): the CLI needs it before it
        builds the solver, to pick the amplicon behaviour."""
        return self._uses_quality[name]

    def get_names(self) -> List[str]:
        return sorted(self._factories)


def _make_greedy() -> Solver:
    from genome_downsampler_tpu_torch.solvers.native_greedy import (
        NativeGreedyMcpSolver,
    )

    return NativeGreedyMcpSolver()


def _make_py_greedy() -> Solver:
    from genome_downsampler_tpu_torch.solvers.greedy_mcp import GreedyMcpSolver

    return GreedyMcpSolver()


def _make_qmcp_cpu() -> Solver:
    from genome_downsampler_tpu_torch.solvers.native_mcmf import NativeQmcpSolver

    return NativeQmcpSolver()


def _make_qmcp_lp() -> Solver:
    from genome_downsampler_tpu_torch.solvers.sequential_mcmf import (
        QmcpSequentialSolver,
    )

    return QmcpSequentialSolver()


def _make_test() -> Solver:
    from genome_downsampler_tpu_torch.solvers.test_solver import TestSolver

    return TestSolver()


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


def _make_qmcp_cuda() -> Solver:
    from genome_downsampler_tpu_torch.solvers.device_mcmf import (
        QmcpDeviceMcmfSolver,
    )

    return QmcpDeviceMcmfSolver(device="cuda")


def _make_quasi_flow_cuda() -> Solver:
    from genome_downsampler_tpu_torch.solvers.push_relabel import (
        QuasiMcpPushRelabelSolver,
    )

    return QuasiMcpPushRelabelSolver(device="cuda")


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
    # the exact weighted optimum: successive shortest paths in one kernel
    reg.register("qmcp-cuda", _make_qmcp_cuda, uses_quality=True)
    # a feasible selection by deterministic push-relabel max-flow
    reg.register("quasi-mcp-flow-cuda", _make_quasi_flow_cuda, uses_quality=False)
    reg.register("test", _make_test, uses_quality=False)
    return reg
