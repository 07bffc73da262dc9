"""The E. coli K-12 cell's parts, held back from ``BENCHMARK.json`` while its
runs spread wider than its bound admits: its configuration, generator,
check, control, limits and tiny reads, each read from its own file, at a
tiny size on the CPU through ``mcp-cuda``'s twin (the blocked engine
there, the genome being above 262,144 bases), and its tiny window with
each fault planted. Once the cell is listed, ``test_benchmark_harness.py``
drives its whole tiny runs too.

    python -m pytest benchmark/tests -q
"""

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT), str(BENCH / "tests")]

from drive_tiny import TINY_DIR, twin  # noqa: E402
from harness import faults, generate, judge, loop, reference, spec  # noqa: E402

CONFIG = json.loads((BENCH / "configs" / "ecoli-k12-wgs.json").read_text())
TRAFFIC = json.loads((BENCH / "traffic" / "mcp.json").read_text())
LIMITS = json.loads((BENCH / "limits" / "ecoli-k12-wgs.mcp.json").read_text())
TINY = json.loads((TINY_DIR / "ecoli-k12-wgs.json").read_text())


def test_the_cell_finds_its_parts():
    assert CONFIG["name"] == "ecoli-k12-wgs" and CONFIG["reduced"] == []
    reads = CONFIG["reads"]
    assert reads["making"] == generate.GENOME_SCALE
    # 500x: 7,736,087 pairs of 2 x 150 bases over 4,641,652
    assert 2 * reads["pairs"] * reads["read_length"] // reads["genome_length"] == 500
    assert TRAFFIC["solver"] == "mcp-cuda" and TRAFFIC["check_samples"] == 1
    assert LIMITS == {"deficit_bases": 0, "bad_indices": 0, "count_gap": 0}
    for name in LIMITS:
        assert callable(spec.load_check(name).measure)
    assert callable(spec.load_control(TRAFFIC["control"]).select)
    assert TINY["reads"]["making"] == generate.GENOME_SCALE


def test_the_tiny_reads_take_the_blocked_engine():
    assert TINY["reads"]["genome_length"] > 262_144
    solver = twin("mcp-cuda")
    smp = generate.sample(TINY["reads"], 3, generate.WINDOW, 0)
    solver.solve(TINY["max_coverage"], loop.read_batch(smp))
    assert solver.inner.last_stats["engine"] == "blocked"


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_fails_and_the_twin_passes(seed):
    m = TINY["max_coverage"]
    smp = generate.sample(TINY["reads"], seed, generate.WINDOW, 0)

    def numbers(sel):
        ans = judge.Answer(smp, sel, m)
        return {n: {"value": spec.load_check(n).measure(ans), "limit": lim}
                for n, lim in LIMITS.items()}

    control = numbers(spec.load_control(TRAFFIC["control"]).select(smp, m))
    assert control["count_gap"]["value"] == 300 and control["deficit_bases"]["value"] == 0
    assert not judge.passed(control)
    sel = twin(TRAFFIC["solver"]).solve(m, loop.read_batch(smp))
    assert judge.passed(numbers(sel))
    assert len(np.unique(sel)) == reference.least_reads(smp, reference.target(smp, m))


@pytest.mark.parametrize("case", ["sound", *faults.FAULTS])
def test_the_window_with_a_fault_is_not_correct(case):
    cell = SimpleNamespace(name="ecoli-k12-wgs.mcp", traffic=TRAFFIC, limits=LIMITS,
                           config={**CONFIG, **TINY}, max_coverage=TINY["max_coverage"])

    def make(name):
        return twin(name) if case == "sound" else faults.Faulty(twin(name), case)

    run = loop.measure(cell, 2**31 + 17, 0.01, False, make, time.perf_counter(), cuda=False)
    assert run.failed == 0 and len(run.answers) == 1 and run.making
    assert judge.passed(loop.check(run)) is (case == "sound")
