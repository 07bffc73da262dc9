"""The port's CLI against the JAX package's CLI, BAM -> BAM."""

import numpy as np
import pytest
import torch

from genome_downsampler_tpu.cli.main import main as jax_main
from genome_downsampler_tpu.testing.bam_writer import write_test_bam_fast
from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform
from genome_downsampler_tpu_torch.cli import main as cli_main
from genome_downsampler_tpu_torch.cli.main import main
from genome_downsampler_tpu_torch.solvers import registry as torch_registry
from genome_downsampler_tpu_torch.solvers.blocked_sweep import (
    BlockedWindowedMcpSolver,
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
    # the port's blocked solver through the CLI: its plain twins stand in
    # for the kernels, by the registry's factory, since there is no card
    monkeypatch.setattr(
        torch_registry, "_make_mcp_cuda", lambda: BlockedWindowedMcpSolver("cpu")
    )
    assert _run(main, bam, tmp_path / "blocked.bam", "mcp-cuda") == ref


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
    rc = main([str(bam), "15", "-o", str(out), "-a", "mcp-cpu", *FILTERS, *flags])
    assert rc != 0 and not out.exists()
    assert errors == [f"{flags[0]} is not yet ported to the CUDA package "
                      "(ROADMAP.md, queue A)"]


def test_cli_argument_errors_and_test_subcommand(bam, tmp_path):
    assert main([]) == 1
    assert main([str(bam), "0"]) == 1
    assert main(["test", "-a", "mcp-cpu", "--scale", "0.002", "-o", str(tmp_path)]) == 0
    assert (tmp_path / "coverage" / "mcp-cpu" / "small_example_test.cov").exists()
