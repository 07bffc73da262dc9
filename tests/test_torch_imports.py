"""The port stays free of JAX, and chip_smoke.py refuses to run without a
card or outside the repository."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import genome_downsampler_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
required = {
    "genome_downsampler_tpu_torch.entry",
    "genome_downsampler_tpu_torch.ops.ablate",
    "genome_downsampler_tpu_torch.ops.sweep",
    "genome_downsampler_tpu_torch.ops.variants",
    "genome_downsampler_tpu_torch.parallel.windows",
    "genome_downsampler_tpu_torch.scripts.bench_kernel_ablate",
    "genome_downsampler_tpu_torch.scripts.kernel_variants",
    "genome_downsampler_tpu_torch.solvers.batched",
    "genome_downsampler_tpu_torch.solvers.device_sweep",
}
assert required <= set(names), sorted(required - set(names))
assert len(names) >= 22, names
loaded = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax."))
assert not loaded, loaded
print("ok", len(names))
"""


def _env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _env()
    env.pop("PYTHONPATH")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "No module named 'genome_downsampler_tpu" in proc.stderr
