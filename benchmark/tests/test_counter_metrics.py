"""The readers of the program's own counters (``metrics/``): each reads
nothing where the program records none (a version of the program without
the counter), and its value on hand-made ``last_stats`` and process
state.

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import spec  # noqa: E402
from harness.loop import Run  # noqa: E402

FLOW = "sarscov2-artic-clinical.quasi-flow"
QMCP = "sarscov2-artic-clinical.qmcp"


def _run(workload, stats):
    return Run(spec.Cell(workload), 1, stats=stats)


def _read(name, run):
    return spec.load_metric(name).read(run)


# two flow solves' counts as the kernel returns them
FLOW_STATS = [
    {"supersteps": 10, "closure_rounds": 100, "closure_ns": 300_000, "superstep_ns": 100_000},
    {"supersteps": 30, "closure_rounds": 300, "closure_ns": 900_000, "superstep_ns": 300_000},
]
SSP_STATS = [
    {"phases": 5, "rounds": 1_000, "rounds_ns": 10_000_000, "tables_ns": 500_000,
     "phase_end_ns": 1_500_000},
    {"phases": 5, "rounds": 3_000, "rounds_ns": 30_000_000, "tables_ns": 1_500_000,
     "phase_end_ns": 4_500_000},
]


@pytest.mark.parametrize("name", ["flow_kernel.closure_share",
                                  "flow_kernel.us_per_closure_round"])
@pytest.mark.parametrize("stats", [[], [None], [{"engine": "torch", "supersteps": 3}]])
def test_flow_counter_readers_read_nothing_without_counters(name, stats):
    assert _read(name, _run(FLOW, stats)) is None


@pytest.mark.parametrize("name", ["ssp_kernel.phase_share", "ssp_kernel.us_per_fixpoint_round"])
@pytest.mark.parametrize("stats", [[], [None], [{"engine": "device", "phases": 2, "rounds": 9}]])
def test_ssp_counter_readers_read_nothing_without_laps(name, stats):
    assert _read(name, _run(QMCP, stats)) is None


def test_flow_counter_readers_on_hand_made_stats():
    run = _run(FLOW, FLOW_STATS + [None])
    # 1.2 ms of closures of 1.6 ms; 1.2 ms over 400 rounds
    assert _read("flow_kernel.closure_share", run) == pytest.approx(75.0)
    assert _read("flow_kernel.us_per_closure_round", run) == pytest.approx(3.0)


def test_ssp_counter_readers_on_hand_made_stats():
    run = _run(QMCP, SSP_STATS + [None])
    # 8 ms of tables and phases' ends of 48 ms; 40 ms over 4,000 rounds
    assert _read("ssp_kernel.phase_share", run) == pytest.approx(100 * 8 / 48)
    assert _read("ssp_kernel.us_per_fixpoint_round", run) == pytest.approx(10.0)


@pytest.fixture
def build(monkeypatch):
    """The program's kernel library module with a fresh process's state."""
    from genome_downsampler_tpu_torch.ops import build

    monkeypatch.setattr(build, "rebuilt", [])
    monkeypatch.setattr(build, "load_seconds", 0.0)
    monkeypatch.setattr(build, "first_call_seconds", {})
    return build


def test_setup_reader_reads_nothing_before_a_kernel_ran(build):
    build.load_seconds = 0.05
    assert _read("setup.kernels_s", _run(FLOW, [])) is None


def test_setup_reader_sums_the_load_and_the_first_calls(build):
    build.load_seconds = 0.05
    build.first_call_seconds.update(gd_push_relabel_solve=0.25, gd_ssp_solve=0.125)
    assert _read("setup.kernels_s", _run(FLOW, [])) == pytest.approx(0.425)


def test_setup_reader_reads_nothing_where_the_process_compiled(build):
    build.load_seconds = 0.05
    build.first_call_seconds["gd_ssp_solve"] = 0.125
    build.rebuilt = ["ssp.cu"]
    assert _read("setup.kernels_s", _run(QMCP, [])) is None


def test_setup_reader_reads_nothing_from_a_program_without_the_counters(monkeypatch, build):
    for name in ("rebuilt", "load_seconds", "first_call_seconds"):
        monkeypatch.delattr(build, name)
    assert _read("setup.kernels_s", _run(QMCP, [])) is None
