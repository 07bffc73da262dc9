"""The process's one-time counters of the kernel library (``ops/build.py``)
and the solve's root region (``SpanGuard``), on the CPU: a stand-in
``nvcc`` and a stand-in library in place of the card's."""

import contextlib
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from genome_downsampler_tpu_torch.ops import build
from genome_downsampler_tpu_torch.solvers.registry import default_registry
from genome_downsampler_tpu_torch.testing.reads_gen import rand_reads_uniform
from genome_downsampler_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
# writes an empty file after each -o, as nvcc writes its object or library
FAKE_NVCC = """#!/bin/sh
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; : > "$1"; fi
  shift
done
"""


class FakeLib:
    """Every entry point of the library, each returning 0."""

    def __init__(self, path):
        for name in (*build._SIGNATURES, "gd_cuda_error_string"):
            setattr(self, name, lambda *args: 0)


@pytest.fixture
def kernels(tmp_path, monkeypatch):
    """A source tree of two kernels and a header, a build directory and a
    fresh process's counters."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "c.cuh"):
        (csrc / name).write_text("// a source\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "_CSRC", csrc)
    monkeypatch.setattr(build, "_BUILD_DIR", out)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
    for name, value in (("_lib", None), ("build_seconds", 0.0), ("load_seconds", 0.0),
                        ("rebuilt", []), ("first_call_seconds", {})):
        monkeypatch.setattr(build, name, value)
    return csrc, out / build._LIB_NAME


def _age(path, seconds):
    t = time.time() - seconds
    os.utime(path, (t, t))


def test_a_process_that_finds_no_library_compiles_every_source(kernels):
    build.load_kernels()
    assert build.rebuilt == ["a.cu", "b.cu", "c.cuh"]
    assert build.build_seconds > 0 and build.load_seconds >= 0


def test_a_process_that_finds_a_fresh_library_compiles_nothing(kernels):
    csrc, lib = kernels
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")
    for src in csrc.iterdir():
        _age(src, 60)
    build.load_kernels()
    assert build.rebuilt == [] and build.build_seconds == 0.0 and build.load_seconds > 0


def test_the_sources_newer_than_the_library_are_named(kernels):
    csrc, lib = kernels
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")
    _age(lib, 30)
    for name in ("a.cu", "c.cuh"):
        _age(csrc / name, 60)
    build.load_kernels()
    assert build.rebuilt == ["b.cu"] and build.build_seconds > 0


def test_a_forced_build_names_every_source_and_a_later_check_keeps_them(kernels):
    build.build_kernels(force=True)
    build.build_kernels()  # fresh now: what this process compiled stays readable
    assert build.rebuilt == ["a.cu", "b.cu", "c.cuh"] and build.build_seconds == 0.0


def test_each_entry_points_first_call_is_timed_once(kernels):
    lib = build.load_kernels()
    assert build.first_call_seconds == {}
    wrapped = lib.gd_ssp_solve
    assert wrapped.argtypes == build._SIGNATURES["gd_ssp_solve"]
    assert lib.gd_ssp_solve(1, 2) == 0
    first = build.first_call_seconds["gd_ssp_solve"]
    assert set(build.first_call_seconds) == {"gd_ssp_solve"} and first >= 0
    # the bare function is back in the library; a kept reference passes through
    assert not isinstance(lib.gd_ssp_solve, build._FirstCall)
    assert wrapped(3) == 0 and lib.gd_ssp_solve(4) == 0
    assert build.first_call_seconds == {"gd_ssp_solve": first}


def test_constructing_both_benchmarked_solvers_imports_no_more_of_the_port():
    """The registry and both solvers of the benchmark's cells (on the CPU,
    where their devices are checked) load these modules of the port and
    nothing beyond what torch and numpy load."""
    code = (
        "import sys\n"
        "import numpy, torch\n"
        "before = set(sys.modules)\n"
        "from genome_downsampler_tpu_torch.solvers.registry import default_registry\n"
        "default_registry()\n"
        "from genome_downsampler_tpu_torch.solvers.push_relabel import QuasiMcpPushRelabelSolver\n"
        "from genome_downsampler_tpu_torch.solvers.device_mcmf import QmcpDeviceMcmfSolver\n"
        "QuasiMcpPushRelabelSolver('cpu'), QmcpDeviceMcmfSolver('cpu')\n"
        "print(' '.join(sorted(set(sys.modules) - before)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    port = "genome_downsampler_tpu_torch"
    expected = {port} | {f"{port}.{m}" for m in (
        "_native", "core", "core.readbatch", "device", "io", "io.build", "ops", "ops.build",
        "ops.coverage", "ops.ssp", "solvers", "solvers.base", "solvers.device_mcmf",
        "solvers.native_mcmf", "solvers.push_relabel", "solvers.registry", "utils",
        "utils.logging", "utils.profiling")}
    assert set(out.stdout.split()) <= expected


def test_each_solve_through_the_registry_is_an_entry_solve_region(tmp_path):
    batch = rand_reads_uniform(np.random.default_rng(4), 200, 1000, 50)
    solver = default_registry().get("mcp-cpu-py")
    with profiling.trace(tmp_path / "prof") as prof:
        solver.solve(5, batch)
        solver.solve(5, batch)
    assert len([e for e in prof.events() if e.name == "entry.solve"]) == 2


def test_the_entry_solve_region_carries_the_process_solve_number(monkeypatch):
    """The number rides in the region's args, so every solve's region has
    one name; it counts the process's solves."""
    seen = []

    def record_function(name, args=None):
        seen.append((name, args))
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    batch = rand_reads_uniform(np.random.default_rng(5), 100, 500, 40)
    solver = default_registry().get("mcp-cpu-py")
    solver.solve(5, batch)
    solver.solve(5, batch)
    roots = [(n, a) for n, a in seen if n == "entry.solve"]
    assert len(roots) == 2 and int(roots[1][1]) == int(roots[0][1]) + 1 >= 2


# ---- the push-relabel kernel's scalars ----

def test_kernel_counts_name_the_push_relabel_kernels_eleven_scalars():
    from genome_downsampler_tpu_torch.ops import push_relabel as pr

    counts = pr.kernel_counts(list(range(100, 111)))
    assert len(pr.SCALARS) == 11 and pr.SCALARS[-1] == "arcs_cta_walked"
    assert counts == {"supersteps": 100, "global_relabels": 102, "closure_rounds": 103,
                      "closure_ns": 104, "superstep_ns": 105, "closure_cycles": 106,
                      "superstep_cycles": 107, "arcs_discharged": 108,
                      "arcs_relabelled": 109, "arcs_cta_walked": 110, "bodies": 100,
                      "host_syncs": 1}
    # a library built from a source of ten scalars is refused, not misread
    with pytest.raises(ValueError, match="10 scalars"):
        pr.kernel_counts(list(range(10)))


def test_the_push_relabel_source_returns_the_scalars_the_wrapper_reads():
    from genome_downsampler_tpu_torch.ops import push_relabel as pr

    text = (Path(pr.__file__).parent / "csrc" / "push_relabel.cu").read_text()
    assert int(re.search(r"scalars: int64\[(\d+)\] out", text).group(1)) == len(pr.SCALARS)
    written = {int(k) for k in re.findall(r"scalars\[(\d+)\]", text)}
    written |= {int(k) for k in re.findall(r"scalars \+ (\d+)\)", text)}
    assert written == set(range(len(pr.SCALARS)))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["uniform", "artic"])
def test_arcs_cta_walked_counts_the_long_segments_alone(layout):
    """Config-1's uniform reads (segments of a few arcs) give no CTA walk;
    the ARTIC layout at 100,000 pairs (segments past 1,040 arcs) gives some,
    a part of what the walks read."""
    from genome_downsampler_tpu_torch.ops import push_relabel as pr
    from genome_downsampler_tpu_torch.testing.flow_cases import (
        ARTIC_CASE,
        flow_case,
        flow_inputs,
    )

    dev = _card()
    if layout == "uniform":
        batch, m, pad = rand_reads_uniform(np.random.default_rng(12345), 25_000, 29_903,
                                           150), 100, 4096
    else:
        batch, m, pad = flow_case(ARTIC_CASE)
    _, _, counts = pr.flow_solve(*flow_inputs(batch, m, pad, dev))
    walked = counts["arcs_discharged"] + counts["arcs_relabelled"]
    assert walked > 0
    if layout == "uniform":
        assert counts["arcs_cta_walked"] == 0
    else:
        assert 0 < counts["arcs_cta_walked"] < walked
