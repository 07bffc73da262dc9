"""The readers of the blocked engine's laps and kernels
(``metrics/blocked_*``): each reads nothing where no solve ran the blocked
engine (the dense engine, a twin without laps, an untraced run), and its
value on hand-made ``last_stats`` and device traces.

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import roofline, spec  # noqa: E402
from harness.loop import Run  # noqa: E402
from harness.trace import SAMPLE_REGION, DeviceTrace  # noqa: E402

CARD = "NVIDIA H100 80GB HBM3"
KERNEL_B = "void (anonymous namespace)::blocked_sweep_kernel<8, true>(int const*, long, int)"
KERNEL_B_WIDE = "void (anonymous namespace)::blocked_sweep_wide_kernel<1>(int const*)"
KERNEL_C = "void (anonymous namespace)::blocked_select_kernel<256>(int const*, signed char*)"


def _blocked(pack, bit_test):
    return {"engine": "blocked", "rounds": 3,
            "phases_s": {"pack": pack, "h2d": 0.01, "sweep": 0.05, "select": 0.002,
                         "d2h": 0.001, "bit test": bit_test}}


DENSE = {"engine": "dense", "phases_s": {"sweep": 0.004, "reconstruct": 0.007}}
# two samples of kernel B's passes (4 and 3 of them), a wide pass and kernel C
TRACE = DeviceTrace(
    ops=[(KERNEL_B, 0, 10_000), (KERNEL_B, 10_000, 20_000), (KERNEL_B, 20_000, 30_000),
         (KERNEL_B, 30_000, 40_000), (KERNEL_C, 40_000, 41_000),
         (KERNEL_B, 100_000, 112_000), (KERNEL_B, 112_000, 124_000),
         (KERNEL_B_WIDE, 124_000, 130_000), (KERNEL_C, 130_000, 131_000),
         ("Memcpy HtoD (Pageable -> Device)", 131_000, 140_000)],
    regions=[(SAMPLE_REGION, 0, 90_000), (SAMPLE_REGION, 95_000, 200_000)])


def _read(name, run):
    return spec.load_metric(name).read(run)


def _run(stats, trace=None, reads=None, genome=None):
    n = len(stats)
    return Run(None, 1, kind=CARD, stats=stats, trace=trace,
               reads=reads or [1_000_000] * n, genome=genome or [400_000] * n)


@pytest.mark.parametrize("stats", [[], [None], [DENSE], [{"engine": "blocked"}]])
def test_host_reader_reads_nothing_without_the_blocked_laps(stats):
    assert _read("blocked_host.ms_per_sample", _run(stats)) is None


def test_host_reader_on_hand_made_laps():
    run = _run([_blocked(0.8, 0.05), _blocked(0.9, 0.07), DENSE, None])
    # (0.85 + 0.97) / 2 seconds, the dense solve and the gap left out
    assert _read("blocked_host.ms_per_sample", run) == pytest.approx(910.0)


@pytest.mark.parametrize("name", ["blocked_kernel.ms_per_pass", "blocked_kernel_roofline"])
def test_kernel_readers_read_nothing_untraced_or_without_the_kernels(name):
    assert _read(name, _run([_blocked(0.8, 0.05)])) is None
    other = DeviceTrace(ops=[("void dense_sweep_kernel<8, false>(int)", 0, 5_000)],
                        regions=[(SAMPLE_REGION, 0, 10_000)])
    assert _read(name, _run([DENSE], trace=other)) is None


def test_kernel_pass_reader_on_a_hand_made_trace():
    # 4 x 10 ms + 2 x 12 ms + 6 ms over 7 passes of kernel B; kernel C left out
    run = _run([_blocked(0.8, 0.05), _blocked(0.8, 0.05)], trace=TRACE)
    assert _read("blocked_kernel.ms_per_pass", run) == pytest.approx(70 / 7)


def test_kernel_roofline_on_a_hand_made_trace():
    run = _run([_blocked(0.8, 0.05), _blocked(0.8, 0.05), DENSE], trace=TRACE,
               reads=[1_000_000, 2_000_000, 50_000], genome=[400_000, 400_000, 30_000])
    least = (roofline.selection_bytes(1_000_000, 400_000, 8)
             + roofline.selection_bytes(2_000_000, 400_000, 8)) / 3.35e12
    # kernels B (70 ms) and C (2 ms); the dense sample's bytes left out
    assert _read("blocked_kernel_roofline", run) == pytest.approx(100 * least / 0.072)
    assert _read("blocked_kernel_roofline", run) < 100


def test_kernel_roofline_reads_nothing_on_a_card_the_table_lacks():
    run = _run([_blocked(0.8, 0.05), _blocked(0.8, 0.05)], trace=TRACE)
    run.kind = "some other card"
    assert _read("blocked_kernel_roofline", run) is None
