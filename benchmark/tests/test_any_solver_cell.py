"""A cell of any registry solver joins the benchmark through new files: the
solver's plain twin (``tests/twins/<solver>.py``) and, for a configuration
of another layout, its tiny reads (``tests/tiny/<config>.json``), beside the
parts the harness finds by name. Here for the twins on file, ``mcp-cuda``'s
among them, and for the tiny reads.

    python -m pytest benchmark/tests -q
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT), str(BENCH / "tests")]

from drive_tiny import TINY, TINY_M, TWINS, tiny_cell, twin  # noqa: E402
from harness import generate, judge, reference, spec  # noqa: E402

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCHMARK["workloads"]]
MIXES = sorted(p.stem for p in (BENCH / "traffic").glob("*.json"))
TWIN_FILES = sorted(p.stem for p in TWINS.glob("*.py"))


@pytest.mark.parametrize("mix", MIXES)
def test_every_mix_names_a_solver_with_a_twin(mix):
    solver = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())["solver"]
    assert solver in TWIN_FILES


@pytest.mark.parametrize("solver", TWIN_FILES)
def test_a_twin_is_its_registry_solver_on_the_cpu(solver, monkeypatch):
    import genome_downsampler_tpu_torch.device as device
    from genome_downsampler_tpu_torch.solvers.registry import default_registry

    mine = twin(solver)
    # the registry's own solver, built for a card that is not looked for
    monkeypatch.setattr(device, "require_cuda", lambda *a, **k: None)
    theirs = default_registry().get(solver)
    assert type(mine) is type(theirs)
    assert type(mine.inner) is type(theirs.inner)
    assert str(mine.inner.device) == "cpu" and str(theirs.inner.device) == "cuda"


def test_a_missing_twin_names_the_file_it_looked_for():
    with pytest.raises(FileNotFoundError, match=r"twins/no-such-solver\.py"):
        twin("no-such-solver")


def test_a_tiny_file_replaces_the_reads(tmp_path):
    reads = {**TINY, "pairs": 100, "amplicons": 2}
    (tmp_path / "sarscov2-artic-clinical.json").write_text(
        json.dumps({"reads": reads, "max_coverage": 7}))
    cell = tiny_cell("sarscov2-artic-clinical.qmcp", tmp_path)
    assert cell.config["reads"] == reads and cell.max_coverage == 7
    assert cell.config["name"] == "sarscov2-artic-clinical"
    # another configuration, with no file there, keeps the ARTIC shape
    other = tiny_cell("sarscov2-artic-deep.quasi-flow", tmp_path)
    assert other.config["reads"] == TINY and other.max_coverage == TINY_M


@pytest.mark.parametrize("workload", WORKLOADS)
def test_without_a_tiny_file_the_reads_stay_tiny(workload, tmp_path):
    cell = tiny_cell(workload, tmp_path)
    assert cell.config["reads"] == TINY and cell.max_coverage == TINY_M


@pytest.mark.parametrize("seed", [1, 2, 3, 2**31 + 9])
def test_mcp_twin_keeps_the_least_count(seed):
    from harness.loop import read_batch

    smp = generate.sample(TINY, seed, generate.WINDOW, 0)
    sel = twin("mcp-cuda").solve(TINY_M, read_batch(smp))
    assert len(np.unique(sel)) == reference.least_reads(smp, reference.target(smp, TINY_M))
    ans = judge.Answer(smp, sel, TINY_M)
    assert spec.load_check("deficit_bases").measure(ans) == 0
    assert spec.load_check("bad_indices").measure(ans) == 0
