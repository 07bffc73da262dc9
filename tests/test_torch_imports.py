"""The port stays free of JAX and of the JAX package, and chip_smoke.py
refuses to run without a card or outside the repository."""

import ast
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
    "genome_downsampler_tpu_torch.cli.main",
    "genome_downsampler_tpu_torch.config",
    "genome_downsampler_tpu_torch.core.readbatch",
    "genome_downsampler_tpu_torch.entry",
    "genome_downsampler_tpu_torch.io.bam",
    "genome_downsampler_tpu_torch.io.build",
    "genome_downsampler_tpu_torch.solvers.native_greedy",
    "genome_downsampler_tpu_torch.solvers.native_mcmf",
    "genome_downsampler_tpu_torch.testing.bam_writer",
    "genome_downsampler_tpu_torch.testing.coverage_tester",
    "genome_downsampler_tpu_torch.ops.ablate",
    "genome_downsampler_tpu_torch.ops.sweep",
    "genome_downsampler_tpu_torch.ops.variants",
    "genome_downsampler_tpu_torch.parallel.blocked_mesh",
    "genome_downsampler_tpu_torch.parallel.launch",
    "genome_downsampler_tpu_torch.parallel.mesh",
    "genome_downsampler_tpu_torch.parallel.sharded_io",
    "genome_downsampler_tpu_torch.parallel.windows",
    "genome_downsampler_tpu_torch.testing.mesh_worker",
    "genome_downsampler_tpu_torch.scripts.bench_kernel_ablate",
    "genome_downsampler_tpu_torch.scripts.kernel_variants",
    "genome_downsampler_tpu_torch.scripts.bench_chr1",
    "genome_downsampler_tpu_torch.scripts.asan_exercise",
    "genome_downsampler_tpu_torch.scripts.bench_kernel",
    "genome_downsampler_tpu_torch.scripts.bench_io",
    "genome_downsampler_tpu_torch.scripts.bench_blocked",
    "genome_downsampler_tpu_torch.scripts.bench_config4_probe",
    "genome_downsampler_tpu_torch.scripts.bench_e2e_quick",
    "genome_downsampler_tpu_torch.scripts.bench_w_scaling",
    "genome_downsampler_tpu_torch.scripts.bench_sharded_qmcp",
    "genome_downsampler_tpu_torch.ops.device_pack",
    "genome_downsampler_tpu_torch.solvers.batched",
    "genome_downsampler_tpu_torch.solvers.device_sweep",
    "genome_downsampler_tpu_torch.ops.ssp",
    "genome_downsampler_tpu_torch.ops.push_relabel",
    "genome_downsampler_tpu_torch.solvers.device_mcmf",
    "genome_downsampler_tpu_torch.solvers.push_relabel",
    "genome_downsampler_tpu_torch.utils.profiling",
}
assert required <= set(names), sorted(required - set(names))
assert len(names) >= 40, names
loaded = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax."))
assert not loaded, loaded
ref = sorted(k for k in sys.modules
             if k == "genome_downsampler_tpu" or k.startswith("genome_downsampler_tpu."))
assert not ref, ref
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


def _jax_package_imports(path: Path) -> list:
    """``file:line module`` of every import of the JAX package in ``path``."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        found += [
            f"{path.relative_to(ROOT)}:{node.lineno} {m}" for m in mods
            if m == "genome_downsampler_tpu" or m.startswith("genome_downsampler_tpu.")
        ]
    return found


def test_port_and_chip_smoke_import_nothing_of_the_jax_package():
    files = [*sorted((ROOT / "genome_downsampler_tpu_torch").rglob("*.py")),
             ROOT / "chip_smoke.py"]
    assert len(files) > 40
    found = [hit for f in files for hit in _jax_package_imports(f)]
    assert not found, found


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
