"""The port's CLI against the JAX package's CLI, BAM -> BAM."""

import json

import numpy as np
import pytest
import torch

from genome_downsampler_tpu.cli.main import main as jax_main
from genome_downsampler_tpu.testing.bam_writer import write_test_bam_fast
from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform
from genome_downsampler_tpu_torch.cli import main as cli_main
from genome_downsampler_tpu_torch.cli.main import main
from genome_downsampler_tpu_torch.parallel import windows as torch_windows
from genome_downsampler_tpu_torch.solvers import registry as torch_registry
from genome_downsampler_tpu_torch.solvers.device_sweep import (
    McpDeviceSweepSolver,
    QmcpDeviceSweepSolver,
)

FILTERS = ["-l", "0", "-q", "0"]


@pytest.fixture
def bam(tmp_path):
    batch = rand_reads_uniform(np.random.default_rng(4), 3000, 12_000, 100)
    src = tmp_path / "in.bam"
    write_test_bam_fast(src, batch)
    return src


def _run(fn, src, out, algo, m="15"):
    assert fn([str(src), m, "-o", str(out), "-a", algo, *FILTERS]) == 0
    return out.read_bytes()


def test_cli_records_equal_jax_cli(bam, tmp_path, monkeypatch):
    ref = _run(jax_main, bam, tmp_path / "jax_tpu.bam", "mcp-tpu")
    assert _run(main, bam, tmp_path / "cpu.bam", "mcp-cpu") == ref
    assert _run(jax_main, bam, tmp_path / "jax_cpu.bam", "mcp-cpu") == ref
    # the port's solver through the CLI: its plain twins stand in for the
    # kernels, by the registry's factory, since there is no card
    monkeypatch.setattr(
        torch_registry, "_make_mcp_cuda", lambda: McpDeviceSweepSolver("cpu")
    )
    assert _run(main, bam, tmp_path / "dense.bam", "mcp-cuda") == ref


def test_cli_windows_records_equal_jax_cli(bam, tmp_path, monkeypatch):
    flags = [*FILTERS, "--windows", "4"]
    jax_out, out = tmp_path / "jax.bam", tmp_path / "torch.bam"
    assert jax_main([str(bam), "15", "-o", str(jax_out), "-a", "mcp-tpu", *flags]) == 0
    # the windowed solver's plain twin stands in for kernel A (no card)
    real = torch_windows.WindowedMcpSolver
    made = []

    def on_cpu(device, n_windows):
        assert device == "cuda"
        made.append(real("cpu", n_windows=n_windows))
        return made[-1]

    monkeypatch.setattr(torch_windows, "WindowedMcpSolver", on_cpu)
    assert main([str(bam), "15", "-o", str(out), "-a", "mcp-cuda", *flags]) == 0
    assert out.read_bytes() == jax_out.read_bytes()
    assert made[0].n_windows == 4 and made[0].last_stats["rounds"] >= 1


def test_cli_mcp_cuda_raises_without_a_card(bam, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out.bam"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([str(bam), "15", "-o", str(out), "-a", "mcp-cuda", *FILTERS])
    assert not out.exists()


@pytest.mark.parametrize(
    "flags", [["--sharded"], ["--windows", "2"], ["--profile-dir", "prof"]]
)
def test_cli_refuses_unported_flags(bam, tmp_path, flags, monkeypatch):
    errors = []
    monkeypatch.setattr(cli_main._log, "error", lambda fmt, *a: errors.append(fmt % a))
    out = tmp_path / "out.bam"
    flags = [str(tmp_path / f) if f == "prof" else f for f in flags]
    rc = main([str(bam), "15", "-o", str(out), "-a", "mcp-cpu", *FILTERS, *flags])
    if flags[0] == "--profile-dir":
        # ported: a torch.profiler trace of the solve, written on the CPU,
        # and the same records as without it
        assert rc == 0 and not errors
        trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
        assert trace["traceEvents"]
        assert out.read_bytes() == _run(main, bam, tmp_path / "plain.bam", "mcp-cpu")
        return
    assert rc != 0 and not out.exists()
    if flags[0] == "--windows":
        # ported: refused only beside a name that would ignore it, with the
        # JAX CLI's message (its accelerator names are the *-cuda ones here)
        assert errors == ["--windows is only supported with "
                          "mcp-cuda/quasi-mcp-cuda; algorithm 'mcp-cpu' would "
                          "silently ignore it"]
    else:
        assert errors == [f"{flags[0]} is not yet ported to the CUDA package "
                          "(ROADMAP.md, queue A)"]


def test_cli_windows_without_a_card_raises(bam, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out.bam"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([str(bam), "15", "-o", str(out), "-a", "mcp-cuda", *FILTERS,
              "--windows", "2"])
    assert not out.exists()


def test_registry_cuda_names_build_the_dense_dispatch(monkeypatch):
    """mcp-cuda is McpDeviceSweepSolver (dense up to the edge, blocked
    above); qmcp-sweep-cuda uses quality; the factories ask for the card."""
    from genome_downsampler_tpu_torch.solvers.blocked_sweep import (
        BlockedWindowedMcpSolver,
    )

    reg = torch_registry.default_registry()
    assert reg.uses_quality_of_reads("qmcp-sweep-cuda")
    assert not reg.uses_quality_of_reads("mcp-cuda")
    asked = []
    monkeypatch.setattr(
        "genome_downsampler_tpu_torch.device.require_cuda",
        lambda: asked.append(1) or torch.device("cuda"),
    )
    for name, cls in (("mcp-cuda", McpDeviceSweepSolver),
                      ("quasi-mcp-cuda", McpDeviceSweepSolver),
                      ("mcp-cuda-blocked", BlockedWindowedMcpSolver),
                      ("qmcp-sweep-cuda", QmcpDeviceSweepSolver)):
        inner = reg.get(name).inner
        assert type(inner) is cls and inner.device.type == "cuda"
    assert len(asked) == 4
    assert reg.get("mcp-cuda").inner.engine == "auto"
    assert reg.get("qmcp-sweep-cuda").inner.max_span == 256


def test_cli_argument_errors_and_test_subcommand(bam, tmp_path):
    assert main([]) == 1
    assert main([str(bam), "0"]) == 1
    assert main(["test", "-a", "mcp-cpu", "--scale", "0.002", "-o", str(tmp_path)]) == 0
    assert (tmp_path / "coverage" / "mcp-cpu" / "small_example_test.cov").exists()
