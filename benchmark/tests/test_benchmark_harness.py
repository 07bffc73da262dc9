"""The benchmark's harness on the CPU: finding a cell's parts by name, the
generators, the plain reference against the port's twins, the arithmetic
of the metrics, the refusals, and whole runs at a tiny size with each
planted fault coming out not correct.

    python -m pytest benchmark/tests -q

The one card test (``cuda`` marker) runs a short cell on the card and
skips here.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import run  # noqa: E402
from harness import faults, generate, guard, judge, reference, roofline, spec  # noqa: E402
from harness.trace import SAMPLE_REGION, DeviceTrace  # noqa: E402

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCHMARK["workloads"]]
_FIRST = {}
for _w in BENCHMARK["workloads"]:
    _FIRST.setdefault(_w["traffic"], _w["name"])
FIRST_OF_MIX = list(_FIRST.values())  # the first cell listed for each traffic mix
DRIVE = BENCH / "tests" / "drive_tiny.py"
sys.path.insert(0, str(DRIVE.parent))
from drive_tiny import TINY, TINY_M, tiny_cell, twin  # noqa: E402


def _batch(smp):
    from harness.loop import read_batch

    return read_batch(smp)


# -- finding the parts by name --------------------------------------------------------

@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_finds_its_files(workload):
    cell = spec.Cell(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert callable(spec.load_control(cell.traffic["control"]).select)
    assert callable(spec.load_generator(cell.config["reads"]["generator"]).layout)
    for name in cell.limits:
        assert callable(spec.load_check(name).measure)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.load_metric(m["name"]).read)


def test_every_metric_and_config_has_its_file():
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for c in BENCHMARK["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert (BENCH / "generators" / f"{conf['reads']['generator']}.py").exists()
    for w in BENCHMARK["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.Cell("no-such-cell")


# -- the generators --------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 12345, 2**31 + 5, 2**40 + 3, -7])
def test_samples_follow_the_seed(seed):
    a = generate.sample(TINY, seed, generate.WINDOW, 3)
    b = generate.sample(TINY, seed, generate.WINDOW, 3)
    c = generate.sample(TINY, seed, generate.WINDOW, 4)
    w = generate.sample(TINY, seed, generate.WARM, 3)
    for k in ("start", "end", "quality"):
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].shape == c[k].shape == (2 * TINY["pairs"],)
    assert not np.array_equal(a["end"], c["end"]) and not np.array_equal(a["end"], w["end"])
    assert a["quality"].min() >= 0 and a["quality"].max() <= TINY["max_quality"]
    assert np.all(a["end"] >= a["start"]) and a["end"].max() < TINY["genome_length"]


def _layout(smp):
    return tuple(sorted(zip(smp["start"].tolist(), smp["end"].tolist())))


@pytest.mark.parametrize("stream", [generate.WINDOW, generate.WARM])
def test_every_seed_runs_the_same_layouts_in_another_order(stream):
    def layouts(seed, first=0):
        return [_layout(generate.sample(TINY, seed, stream, i))
                for i in range(first, first + generate.BLOCK)]

    a, b = layouts(2**31 + 5), layouts(77)
    assert sorted(a) == sorted(b) and a != b and len(set(a)) == generate.BLOCK
    # the same layout under two seeds: its pairs in another order, other MAPQ
    x = generate.sample(TINY, 2**31 + 5, stream, 0)
    y = generate.sample(TINY, 77, stream, b.index(a[0]))
    assert not np.array_equal(x["start"], y["start"])
    assert not np.array_equal(x["quality"], y["quality"])
    # the next block takes layouts of its own
    assert not set(a) & set(layouts(77, generate.BLOCK))


def test_mates_stay_adjacent_after_the_shuffle():
    smp = generate.sample(TINY, 5, generate.WINDOW, 0)
    a = TINY["first"] + (np.arange(TINY["amplicons"]) * TINY["stride"])
    first, second = smp["start"][0::2], smp["end"][1::2]
    assert np.all(np.isin(first, a))
    # the second mate of each pair ends at its own amplicon's end
    np.testing.assert_array_equal(second, first + TINY["amplicon_length"] - 1)


def test_frozen_copy_matches_the_port_generator():
    from genome_downsampler_tpu_torch.testing.long_reads import amplicon_pairs

    kw = {k: v for k, v in TINY.items() if k not in ("generator", "max_quality")}
    mine = spec.load_generator("amplicon_pairs").layout(np.random.default_rng(5), **kw)
    port = amplicon_pairs(np.random.default_rng(5), **kw)
    np.testing.assert_array_equal(mine[0], port.start)
    np.testing.assert_array_equal(mine[1], port.end)


# -- the plain reference against the port's twins ---------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_agrees_with_the_twins(seed):
    from genome_downsampler_tpu_torch.solvers.registry import default_registry

    smp = generate.sample(TINY, seed, generate.WINDOW, 0)
    batch = _batch(smp)
    t = reference.target(smp, TINY_M)
    greedy = default_registry().get("mcp-cpu-py").solve(TINY_M, batch)
    assert reference.least_reads(smp, t) == len(greedy)
    least = reference.least_selection(smp, t)
    assert len(least) == len(greedy)
    assert np.all(reference.coverage(smp["start"], smp["end"], TINY["genome_length"], least) >= t)
    qmcp = twin("qmcp-cuda").solve(TINY_M, batch)
    assert reference.least_cost(smp, t) == int(reference.costs(smp)[qmcp].sum())
    flow = twin("quasi-mcp-flow-cuda").solve(TINY_M, batch)
    ans = judge.Answer(smp, flow, TINY_M)
    assert spec.load_check("deficit_bases").measure(ans) == 0
    assert spec.load_check("bad_indices").measure(ans) == 0
    assert ans.kept.size >= len(least)


def test_reference_target_and_coverage():
    smp = {"start": np.array([0, 2, 2, 5]), "end": np.array([3, 4, 1, 9]), "quality": np.array([5, 7, 9, 9]),
           "genome_length": 8}
    np.testing.assert_array_equal(reference.coverage(smp["start"], smp["end"], 8),
                                  [1, 1, 2, 2, 1, 1, 1, 1])
    np.testing.assert_array_equal(reference.target(smp, 1), [1] * 8)
    np.testing.assert_array_equal(reference.costs(smp), [5, 3, 1, 1])
    assert reference.least_reads(smp, reference.target(smp, 1)) == 3


# -- the controls come out not correct, the program correct ------------------------------

@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_fails_the_limits(workload, seed):
    cell = tiny_cell(workload)
    m = cell.max_coverage
    smp = generate.sample(cell.config["reads"], seed, generate.WINDOW, 0)
    numbers = {}
    for name, limit in cell.limits.items():
        control = spec.load_control(cell.traffic["control"]).select
        ans = judge.Answer(smp, control(smp, m), m)
        numbers[name] = {"value": spec.load_check(name).measure(ans), "limit": limit}
    assert not judge.passed(numbers)
    sel = twin(cell.traffic["solver"]).solve(m, _batch(smp))
    ans = judge.Answer(smp, sel, m)
    assert judge.passed({name: {"value": spec.load_check(name).measure(ans), "limit": limit}
                         for name, limit in cell.limits.items()})


def test_checked_indices_are_drawn_from_the_seed():
    a = judge.checked_indices(9, range(100), 8)
    assert a == judge.checked_indices(9, range(100), 8) and len(set(a)) == 8
    assert judge.checked_indices(9, [3, 5], 8) == [3, 5]


@pytest.mark.parametrize("workload", FIRST_OF_MIX)
def test_whole_runs_with_faults_are_not_correct(workload):
    cases = ["sound", *faults.FAULTS]
    out = subprocess.run([sys.executable, str(DRIVE), workload, *cases], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    results = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(results) == len(cases)
    for case, res in zip(cases, results):
        assert res["correct"] is (case == "sound"), (case, res["checks"])
        assert list(res)[-1] == "checks"
        assert set(res) >= {"correct", "attempted", "failed", "metrics", "device"}
        assert "jax" not in out.stderr.lower()


# -- the arithmetic of the metrics -------------------------------------------------------

def test_roofline_arithmetic():
    assert roofline.selection_bytes(1000, 100, 8) == 8000 + 400 + 125
    assert roofline.least_seconds("NVIDIA H100 80GB HBM3", 3.35e12) == pytest.approx(1.0)
    assert roofline.least_seconds("some other card", 1e9) is None


def test_percentile_of_the_spans():
    from harness.loop import Run

    read = spec.load_metric("sample_s.p95").read
    assert read(Run(None, 0, spans=[float(x) for x in range(101)])) == pytest.approx(95.0)
    assert read(Run(None, 0, spans=[1.0, 2.0, 3.0, 4.0, 5.0])) == pytest.approx(4.8)
    assert read(Run(None, 0)) is None


def test_trace_busy_idle_and_gaps():
    tr = DeviceTrace(
        ops=[("k1", 10, 20), ("k2", 15, 30), ("copy", 50, 60), ("k1", 110, 190)],
        regions=[(SAMPLE_REGION, 0, 100), ("flow.arcs", 30, 50), (SAMPLE_REGION, 100, 200),
                 ("flow.select", 190, 200)])
    assert tr.window_s() == pytest.approx(200e-6)
    assert tr.busy_s() == pytest.approx((20 + 10 + 80) * 1e-6)
    assert tr.op_seconds("k1") == pytest.approx(90e-6)
    assert tr.device_ops(2) == [["k1", pytest.approx(90e-6)], ["k2", pytest.approx(15e-6)]]
    gaps = dict((n, v) for n, v in tr.idle_gaps())
    assert gaps["flow.arcs"] == pytest.approx(20e-6)
    assert gaps["flow.select"] == pytest.approx(10e-6)
    assert gaps[SAMPLE_REGION] == pytest.approx((10 + 40 + 10) * 1e-6)


def test_metric_readers_on_a_run():
    from harness.loop import Run

    cell = spec.Cell("sarscov2-artic-clinical.quasi-flow")
    r = Run(cell, 1, kind="NVIDIA H100 80GB HBM3", setup_s=12.5, spans=[0.5, 0.25, 0.25],
            reads=[100, 100, 100], genome=[10, 10, 10],
            stats=[{"laps_s": {"coverage": 0.001, "arcs": 0.002, "select": 0.003},
                    "supersteps": 10, "superstep_ns": 50_000}] * 3,
            trace=DeviceTrace(ops=[("void push_relabel_kernel<false>(Net)", 0, 1e6)],
                              regions=[(SAMPLE_REGION, 0, 2e6)]))
    read = {m: spec.load_metric(m).read(r) for m in (
        "reads_per_s", "sample_s.p95", "setup_s", "flow_host.ms_per_sample",
        "flow_kernel.us_per_superstep", "flow_kernel_roofline", "device.idle_pct",
        "ssp_kernel_roofline", "qmcp_host.ms_per_sample")}
    assert read["reads_per_s"] == pytest.approx(300)
    assert read["setup_s"] == 12.5
    assert read["flow_host.ms_per_sample"] == pytest.approx(6.0)
    assert read["flow_kernel.us_per_superstep"] == pytest.approx(5.0)
    assert read["flow_kernel_roofline"] == pytest.approx(
        100 * 3 * roofline.selection_bytes(100, 10, 8) / 3.35e12)
    assert read["device.idle_pct"] == pytest.approx(50.0)
    assert read["ssp_kernel_roofline"] is None and read["qmcp_host.ms_per_sample"] is None


# -- the refusals ---------------------------------------------------------------------------

def test_jax_check_compares_top_level_names_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "genome_downsampler_tpu",
             "genome_downsampler_tpu.ops.coverage", "genome_downsampler_tpu_torch",
             "genome_downsampler_tpu_torch.ops", "jaxtyping", "numpy"]
    assert guard.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "genome_downsampler_tpu",
         "genome_downsampler_tpu.ops.coverage"])


def test_the_harness_loads_no_jax():
    code = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]; "
            "import run; from harness import faults, judge, loop, trace; "
            "import genome_downsampler_tpu_torch.solvers.push_relabel; "
            "import genome_downsampler_tpu_torch.solvers.device_mcmf; "
            "from harness import guard; print(guard.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_a_card_fails(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", WORKLOADS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "no CUDA device" in out.err


# -- on the card --------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
def test_a_short_cell_on_the_card(card):
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", WORKLOADS[0],
                          "--seed", "123", "--seconds", "2", "--trace", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"] and res["device"]["kind"] == card and res["device"]["busy_s"] > 0
