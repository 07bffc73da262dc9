"""The port's profiler hooks (``utils/profiling.py``), on the CPU."""

import json

import numpy as np
import torch

from genome_downsampler_tpu_torch.solvers.blocked_sweep import BlockedWindowedMcpSolver
from genome_downsampler_tpu_torch.solvers.device_mcmf import QmcpDeviceMcmfSolver
from genome_downsampler_tpu_torch.testing.reads_gen import rand_reads_uniform
from genome_downsampler_tpu_torch.utils import profiling


def test_trace_none_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profiling.trace(None) as prof:
        x = torch.arange(10).sum()
    assert prof is None and int(x) == 45
    assert list(tmp_path.iterdir()) == []


def test_trace_writes_the_solvers_named_laps(tmp_path):
    batch = rand_reads_uniform(np.random.default_rng(1), 400, 2000, 50)
    with profiling.trace(tmp_path / "prof") as prof:
        BlockedWindowedMcpSolver("cpu", n_windows=4, block=64, max_span=64).solve(5, batch)
        QmcpDeviceMcmfSolver("cpu").solve(5, batch)
    names = {e.key for e in prof.key_averages()}
    events = json.loads((tmp_path / "prof" / profiling.TRACE_FILE).read_text())
    traced = {e.get("name") for e in events["traceEvents"]}
    laps = {f"blocked.{k}" for k in ("pack", "h2d", "sweep", "select", "d2h", "bit test")}
    laps |= {"qmcp.buckets", "qmcp.ssp", "qmcp.select"}
    assert laps <= names and laps <= traced


def test_host_only_cli_run_does_not_import_torch(tmp_path):
    """-a mcp-cpu through the port's CLI stays a host program: the profiler
    hooks import torch only when a trace or a region is asked for."""
    import subprocess
    import sys
    from pathlib import Path

    from genome_downsampler_tpu_torch.testing.bam_writer import write_test_bam_fast

    src = tmp_path / "in.bam"
    write_test_bam_fast(src, rand_reads_uniform(np.random.default_rng(3), 500, 5000, 100))
    code = (
        "import sys\n"
        "from genome_downsampler_tpu_torch.cli.main import main\n"
        f"rc = main([{str(src)!r}, '10', '-o', {str(tmp_path / 'out.bam')!r}, "
        "'-a', 'mcp-cpu', '-l', '0', '-q', '0'])\n"
        "print(rc, 'torch' in sys.modules)\n"
    )
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(root),
                                        "HOME": str(tmp_path)}, timeout=300)
    assert out.stdout.split() == ["0", "False"], out.stderr[-2000:]
