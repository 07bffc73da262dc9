"""The port's AddressSanitizer gate (``genome_downsampler_tpu_torch/scripts/
run_asan.sh``): an instrumented host library, loaded through ``GD_HOST_SO``,
driven through every symbol ``_native`` binds; and the override itself."""

import shutil
import subprocess
from pathlib import Path

import pytest

from genome_downsampler_tpu_torch import _native
from genome_downsampler_tpu_torch.io import build

ROOT = Path(__file__).resolve().parents[1]
OK_LINE = "ASAN exercise: all native paths OK"


def _libasan():
    """The path ``g++ -print-file-name=libasan.so`` names, or None where it
    names no file (g++ prints the bare name when it has none)."""
    if shutil.which("g++") is None:
        return None
    out = subprocess.run(["g++", "-print-file-name=libasan.so"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return out if Path(out).is_file() else None


def test_asan_gate_drives_every_bound_symbol():
    if _libasan() is None:
        pytest.skip("g++ names no libasan.so here")
    proc = subprocess.run(
        ["bash", "genome_downsampler_tpu_torch/scripts/run_asan.sh"], cwd=ROOT,
        capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    lines = proc.stdout.splitlines()
    assert OK_LINE in lines
    symbols = next(line for line in lines if line.startswith("symbols:")).split()[1:]
    assert symbols == sorted(_native._SIGNATURES)


def test_build_loads_the_library_gd_host_so_names(monkeypatch, tmp_path):
    so = tmp_path / "libinstrumented.so"  # need not exist: no check, no build
    monkeypatch.setenv("GD_HOST_SO", str(so))
    assert build.build_bamio() == so
    assert build.build_bamio(force=True) == so
    monkeypatch.delenv("GD_HOST_SO")
    assert build.build_bamio() == build._SO
