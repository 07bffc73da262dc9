"""The reader of the push-relabel kernel's CTA walk counter
(``metrics/flow_kernel.cta_walk_share.py``): nothing where no solve
carries the counter (a version of the program without it), and its value
on hand-made ``last_stats``.

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import spec  # noqa: E402
from harness.loop import Run  # noqa: E402

DEEP = "sarscov2-artic-deep.quasi-flow"
NAME = "flow_kernel.cta_walk_share"


def _read(stats):
    return spec.load_metric(NAME).read(Run(spec.Cell(DEEP), 1, stats=stats))


@pytest.mark.parametrize("stats", [
    [],
    [None],
    [{"engine": "torch", "supersteps": 3}],
    # the parent's kernel: arcs counted, no CTA walk counter
    [{"supersteps": 10, "arcs_discharged": 500, "arcs_relabelled": 100}],
    # a solve that walked nothing
    [{"supersteps": 0, "arcs_discharged": 0, "arcs_relabelled": 0, "arcs_cta_walked": 0}],
])
def test_cta_walk_share_reads_nothing_without_the_counter(stats):
    assert _read(stats) is None


def test_cta_walk_share_on_hand_made_stats():
    stats = [
        {"arcs_discharged": 3_000, "arcs_relabelled": 1_000, "arcs_cta_walked": 3_500},
        {"arcs_discharged": 500, "arcs_relabelled": 500, "arcs_cta_walked": 0},
        None,
        {"arcs_discharged": 700, "arcs_relabelled": 0},  # no counter: left out
    ]
    # 3,500 of the 5,000 arcs the counted solves' walks read
    assert _read(stats) == pytest.approx(70.0)


def test_cta_walk_share_is_zero_where_no_segment_is_long():
    stats = [{"arcs_discharged": 800, "arcs_relabelled": 200, "arcs_cta_walked": 0}]
    assert _read(stats) == 0.0
