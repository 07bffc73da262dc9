"""The port's blocked solver as a whole (plain twins on the CPU) against the
JAX ``BlockedWindowedMcpSolver`` (Pallas interpret mode) and the host
greedy; the registry's ``*-cuda`` names and the no-fallback rules."""

import numpy as np
import pytest
import torch

from genome_downsampler_tpu.core.readbatch import ReadBatch
from genome_downsampler_tpu.solvers.blocked_sweep import (
    BlockedWindowedMcpSolver as JaxBlockedSolver,
)
from genome_downsampler_tpu.solvers.greedy_mcp import GreedyMcpSolver
from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform
from genome_downsampler_tpu_torch import _native
from genome_downsampler_tpu_torch.ops import blocked, build
from genome_downsampler_tpu_torch.solvers import blocked_sweep
from genome_downsampler_tpu_torch.solvers.blocked_sweep import (
    BlockedWindowedMcpSolver,
)
from genome_downsampler_tpu_torch.solvers.native_greedy import NativeGreedyMcpSolver
from genome_downsampler_tpu_torch.solvers.registry import default_registry

KW = dict(n_windows=4, block=64, max_span=64, chunk=64)


def _batch(start, end, n):
    r = len(start)
    return ReadBatch(
        bam_id=np.arange(r, dtype=np.int64),
        start=np.asarray(start, np.int64),
        end=np.asarray(end, np.int64),
        quality=np.full(r, 50, np.int64),
        seq_length=(np.asarray(end) - np.asarray(start) + 1).astype(np.int64),
        is_first=np.tile([True, False], r // 2 + 1)[:r],
        ref_genome_length=n,
    )


@pytest.mark.parametrize("seed,m", [(7, 5), (0, 4), (5, 9)])
def test_solver_matches_jax_solver_and_greedy(seed, m):
    batch = rand_reads_uniform(np.random.default_rng(seed), 1200, 2000, 50)
    solver = BlockedWindowedMcpSolver("cpu", **KW)
    sel = solver.solve(m, batch)
    np.testing.assert_array_equal(
        sel, JaxBlockedSolver(interpret=True, **KW).solve(m, batch)
    )
    np.testing.assert_array_equal(sel, GreedyMcpSolver().solve(m, batch))
    stats = solver.last_stats
    assert stats["rounds"] >= 1 and stats["device"] == "cpu"
    assert list(stats["phases_s"]) == [
        "pack", "h2d", "sweep", "select", "d2h", "bit test"
    ]


def test_solver_duplicates_and_window_spill_match_jax():
    rng = np.random.default_rng(11)
    n, L = 2048, 64
    parts = []
    for ci in range(60):
        s = int(rng.integers(0, n - L))
        k = 100 if ci == 0 else int(rng.integers(2, 24))
        parts.append(np.tile([[s, s + int(rng.integers(4, L - 1)) - 1]], (k, 1)))
    s = rng.integers(0, n - L, 800)
    parts.append(np.stack([s, s + rng.integers(1, L - 1, 800) - 1], axis=1))
    iv = np.concatenate(parts)
    rng.shuffle(iv)
    batch = _batch(iv[:, 0], iv[:, 1], n)
    for m in (3, 11):
        sel = BlockedWindowedMcpSolver("cpu", **KW).solve(m, batch)
        np.testing.assert_array_equal(
            sel, JaxBlockedSolver(interpret=True, **KW).solve(m, batch)
        )


def test_default_geometry_span_upgrade_matches_greedy_and_jax():
    """One read of span exactly DEFAULT_MAX_SPAN: L upgrades to 384 and B
    drops to 128 (the selection's halo needs L % B == 0)."""
    rng = np.random.default_rng(11)
    n, r = 8_192, 400
    start = rng.integers(0, n - 700, r)
    span = rng.integers(30, 200, r)
    start[0], span[0] = 100, 256
    batch = _batch(start, start + span - 1, n)
    solver = BlockedWindowedMcpSolver("cpu")
    assert solver._geometry(n, 256)[1:3] == (128, 384)
    sel = solver.solve(4, batch)
    assert solver.last_stats["max_span"] == 384
    np.testing.assert_array_equal(sel, GreedyMcpSolver().solve(4, batch))
    np.testing.assert_array_equal(
        sel, JaxBlockedSolver(interpret=True).solve(4, batch)
    )


@pytest.mark.parametrize("n,span,W", [(4096, 1400, 8), (40_000, 1000, None),
                                      (40_000, 4094, None)])
def test_windows_shorter_than_a_read_shrink_to_fit(n, span, W):
    """A read may cross one window edge, not two: where a window would be
    shorter than L (the JAX solver raises there), W halves until it is not,
    a given n_windows too; the selection stays mcp-cpu's (the host C++
    greedy)."""
    rng = np.random.default_rng(span)
    start = rng.integers(0, n - span, n // 4)
    batch = _batch(start, start + rng.integers(0, span, n // 4), n)
    solver = BlockedWindowedMcpSolver("cpu", n_windows=W)
    sel = solver.solve(5, batch)
    st = solver.last_stats
    assert st["positions_per_pass"] >= st["max_span"] >= span
    np.testing.assert_array_equal(sel, NativeGreedyMcpSolver().solve(5, batch))


def test_geometry_is_the_jax_geometry():
    ours, ref = BlockedWindowedMcpSolver("cpu"), JaxBlockedSolver()
    for n in (8_192, 100_000, 1_000_000, 5_000_000, 60_000_000):
        for span_max in (100, 150, 255, 256, 300, 513, 640):
            for density in (10.0, 300.0):
                assert ours._geometry(n, span_max, density) == ref._geometry(
                    n, span_max, density
                )


def test_uint16_sentinel_free_top_code_and_empty_batch():
    """A read at the top of the code space (start_rel B-1, span L-1) stays
    distinct from the 0xFFFF pad; an empty batch selects nothing."""
    rng = np.random.default_rng(9)
    n, r = 2048, 800
    start = rng.integers(0, n - 64, r)
    span = rng.integers(1, 64, r)
    start[0], span[0] = 63, 63
    batch = _batch(start, start + span - 1, n)
    sel = BlockedWindowedMcpSolver("cpu", **KW).solve(3, batch)
    np.testing.assert_array_equal(
        sel, JaxBlockedSolver(interpret=True, **KW).solve(3, batch)
    )
    empty = _batch(np.zeros(0, np.int64), np.zeros(0, np.int64), n)
    assert BlockedWindowedMcpSolver("cpu").solve(3, empty).size == 0


def test_interleaved_pack_call_is_detected(monkeypatch):
    batch = rand_reads_uniform(np.random.default_rng(2), 300, 2000, 50)
    real = blocked_sweep.blocked_windowed_sweep

    def interleaved(*a, **k):
        _native.pack_flat_direct(batch.start, batch.end, 2000, 4, 64, 64, 64)
        return real(*a, **k)

    monkeypatch.setattr(blocked_sweep, "blocked_windowed_sweep", interleaved)
    with pytest.raises(RuntimeError, match="overwritten"):
        BlockedWindowedMcpSolver("cpu", **KW).solve(4, batch)


def test_registry_names_and_cpu_solvers():
    reg = default_registry()
    for name in ("mcp-cuda", "quasi-mcp-cuda", "mcp-cuda-blocked",
                 "qmcp-sweep-cuda", "mcp-cpu", "quasi-mcp-cpu", "mcp-cpu-py",
                 "qmcp-cpu", "qmcp-lp-cpu", "test"):
        assert reg.contains(name)
    assert not reg.uses_quality_of_reads("mcp-cuda")
    batch = rand_reads_uniform(np.random.default_rng(1), 500, 3000, 60)
    np.testing.assert_array_equal(
        reg.get("mcp-cpu").solve(6, batch), GreedyMcpSolver().solve(6, batch)
    )


@pytest.mark.parametrize(
    "name", ["mcp-cuda", "quasi-mcp-cuda", "mcp-cuda-blocked", "qmcp-sweep-cuda"]
)
def test_cuda_names_raise_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        default_registry().get(name)


def test_no_fallback_paths(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BlockedWindowedMcpSolver("cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        BlockedWindowedMcpSolver("meta")
    # tensors on a device that is neither CPU nor CUDA: no silent twin
    p = torch.zeros((1, 1, 64), dtype=torch.int32, device="meta")
    c = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    z = torch.zeros((1, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no blocked sweep"):
        blocked.blocked_sweep_pass(p, c, None, z, z, 1, 64, 64, auto_target=True)
    with pytest.raises(ValueError, match="no selection pass"):
        blocked.blocked_selection_pass(p, c, z.reshape(-1), z, 1, 64, 0)
    # the kernel build raises without nvcc instead of falling back
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_BUILD_DIR", build.Path("/nonexistent/gd"))
    if not build.Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(build.KernelBuildError, match="nvcc not found"):
            build.load_kernels()
