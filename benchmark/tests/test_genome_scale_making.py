"""The samples' making: the default path bit for bit as pinned, and the
genome-scale path (``"making": "genome_scale"``) with the default path's
guarantees, at a tiny size; the loop's reservoir of answers.

    python -m pytest benchmark/tests -q
"""

import hashlib
import json
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT), str(BENCH / "tests")]

from harness import generate, judge, loop, spec  # noqa: E402

TINY = json.loads((BENCH / "tests" / "tiny" / "ecoli-k12-wgs.json").read_text())["reads"]
SMALL = {**TINY, "genome_length": 20_000, "pairs": 3_000}  # quick to draw

# sha256 over the first 32 samples of a stream (their arrays, then the
# ReadBatch's) as the harness made them before the genome-scale making
# existed: those configurations' samples may not move
PINNED = {
    ("sarscov2-artic-clinical", 0, 12345):
        "a2e6310f22d7dd0c06f41aeaa72720c5d07ec09ee779c17e55f246981dbd5cf5",
    ("sarscov2-artic-clinical", 0, 2147483653):
        "17fd38956ef68fe96809672249c545f7fc9651936e61393b0df6d3bdf8c3ce97",
    ("sarscov2-artic-clinical", 1, 12345):
        "a24cb85624b9b2f2bd3b44447c1738d828662872ce7d4fbc5274ae5d82c9277a",
    ("sarscov2-artic-clinical", 1, 2147483653):
        "39ee7c553ae1f16cd548d4232a73f4a4323867cf380b84603769f849b5a788d1",
    ("sarscov2-artic-deep", 0, 12345):
        "5caf3c2bd2a5bafe3bb410edae497f0b81056f27638a9cd75cf1fa9030fbc08e",
    ("sarscov2-artic-deep", 0, 2147483653):
        "257420acccba28e6edd8e20a214f6db360996cb7d225a74008b651dc87ce5a4f",
    ("sarscov2-artic-deep", 1, 12345):
        "65f17f659d9ba1cdb78a8922fcb2eccde4f2030a1ed8271a7bb2f3749815b666",
    ("sarscov2-artic-deep", 1, 2147483653):
        "e3cc8570d967152751810d585cbc41eff3ec9d7c9a6729fb77ff057ae16036c2",
}


def _digest(reads, seed, stream, n=32):
    h = hashlib.sha256()
    for i in range(n):
        smp = generate.sample(reads, seed, stream, i)
        b = loop.read_batch(smp)
        for a in (smp["start"], smp["end"], smp["quality"], b.bam_id, b.start, b.end,
                  b.quality, b.seq_length, b.is_first):
            h.update(str(a.dtype).encode())
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(str(smp["genome_length"]).encode())
        h.update(str(b.ref_genome_length).encode())
    return h.hexdigest()


@pytest.mark.parametrize("config,stream,seed", sorted(PINNED))
def test_default_making_is_pinned(config, stream, seed):
    reads = json.loads((BENCH / "configs" / f"{config}.json").read_text())["reads"]
    assert "making" not in reads
    assert _digest(reads, seed, stream) == PINNED[config, stream, seed]


# -- the genome-scale path's guarantees ------------------------------------------------

def _pairs(smp):
    """The sample's pairs as a sorted tuple of (start, end, start, end)."""
    s, e = smp["start"].reshape(-1, 2), smp["end"].reshape(-1, 2)
    return tuple(sorted(map(tuple, np.concatenate([s[:, :1], e[:, :1], s[:, 1:], e[:, 1:]],
                                                   axis=1).tolist())))


def _fresh(reads, seed, stream, index):
    generate._genome_scale.cache_clear()
    return generate.sample(reads, seed, stream, index)


@pytest.mark.parametrize("seed", [0, 12345, 2**31 + 5, 2**40 + 3, -7])
def test_genome_scale_sample_is_a_function_of_seed_stream_index(seed):
    a = generate.sample(SMALL, seed, generate.WINDOW, 3)
    b = _fresh(SMALL, seed, generate.WINDOW, 3)
    for k in ("start", "end", "quality", "seq_length", "bam_id", "is_first"):
        np.testing.assert_array_equal(a[k], b[k])
    c = generate.sample(SMALL, seed, generate.WINDOW, 4)
    w = generate.sample(SMALL, seed, generate.WARM, 3)
    assert _pairs(a) != _pairs(c) and _pairs(a) != _pairs(w)


@pytest.mark.parametrize("stream", [generate.WINDOW, generate.WARM])
def test_genome_scale_seeds_run_the_same_layouts_in_another_order(stream):
    def layouts(seed, first=0):
        return [_pairs(generate.sample(SMALL, seed, stream, i))
                for i in range(first, first + generate.BLOCK)]

    a, b = layouts(2**31 + 5), layouts(77)
    assert sorted(a) == sorted(b) and a != b and len(set(a)) == generate.BLOCK
    # the same layout under two seeds: its pairs in another order, other MAPQ
    x = generate.sample(SMALL, 2**31 + 5, stream, 0)
    y = generate.sample(SMALL, 77, stream, b.index(a[0]))
    assert not np.array_equal(x["start"], y["start"])
    assert not np.array_equal(x["quality"], y["quality"])
    # the next block takes layouts of its own
    assert not set(a) & set(layouts(77, generate.BLOCK))


def test_genome_scale_hands_no_layout_over_twice():
    seen = [_pairs(generate.sample(SMALL, 5, generate.WINDOW, i)) for i in range(64)]
    warm = _pairs(generate.sample(SMALL, 5, generate.WARM, 0))
    assert len(set(seen)) == 64 and warm not in seen


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_genome_scale_reads_are_pairs_inside_the_genome(seed):
    n = SMALL["genome_length"]
    for i in (0, 1, 9, 40):
        smp = generate.sample(SMALL, seed, generate.WINDOW, i)
        s, e = smp["start"].astype(np.int64), smp["end"].astype(np.int64)
        assert s.dtype == e.dtype and smp["start"].dtype == np.int32
        assert len(s) == 2 * SMALL["pairs"]
        assert s.min() >= 0 and e.max() <= n - 1 and np.all(e >= s)
        # mates adjacent, first mate first: it reads from the fragment's start,
        # the second mate to its end
        np.testing.assert_array_equal(e[0::2] - s[0::2] + 1, SMALL["read_length"])
        np.testing.assert_array_equal(e[1::2] - s[1::2] + 1, SMALL["read_length"])
        frag = e[1::2] - s[0::2] + 1
        assert frag.min() >= SMALL["min_fragment"] and frag.max() <= SMALL["max_fragment"]
        np.testing.assert_array_equal(smp["seq_length"], e - s + 1)


@pytest.mark.parametrize("index", [0, 5])
def test_genome_scale_mapq_is_uniform_in_its_range(index):
    q = generate.sample({**SMALL, "pairs": 30_000}, 11, generate.WINDOW, index)["quality"]
    counts = np.bincount(q, minlength=SMALL["max_quality"] + 1)
    assert q.min() >= 0 and q.max() <= SMALL["max_quality"]
    expected = len(q) / (SMALL["max_quality"] + 1)  # about 984, sd 31
    assert counts.min() > 0.8 * expected and counts.max() < 1.2 * expected


def test_genome_scale_layout_zero_is_the_default_paths_and_others_move_it():
    """Layout ``k`` is the default path's layout 0 with every anchor moved
    by ``k * step`` modulo ``D``."""
    base = generate._genome_scale(json.dumps(SMALL, sort_keys=True), generate.WINDOW)
    plain = {k: v for k, v in SMALL.items() if k != "making"}
    lay0 = next(i for i in range(generate.BLOCK)
                if generate.layout_index(9, generate.WINDOW, i) == 0)
    assert _pairs(generate.sample(SMALL, 9, generate.WINDOW, lay0)) == _pairs(
        generate.sample(plain, 9, generate.WINDOW, lay0))
    a0 = np.sort(generate.sample(SMALL, 9, generate.WINDOW, lay0)["start"][0::2].astype(np.int64))
    for i in (3, 21):
        k = generate.layout_index(9, generate.WINDOW, i)
        ak = np.sort(generate.sample(SMALL, 9, generate.WINDOW, i)["start"][0::2].astype(np.int64))
        np.testing.assert_array_equal(ak, np.sort((a0 + k * base.step) % base.domain))
    assert base.domain == SMALL["genome_length"] - SMALL["max_fragment"] + 1


def test_genome_scale_batch_shares_its_arrays_read_only():
    smp = generate.sample(SMALL, 4, generate.WINDOW, 2)
    b = loop.read_batch(smp)
    for k in ("start", "end", "quality", "seq_length", "bam_id", "is_first"):
        assert np.shares_memory(getattr(b, k), smp[k]), k
    for k in ("quality", "seq_length", "bam_id", "is_first"):
        assert not smp[k].flags.writeable, k
        with pytest.raises(ValueError):
            smp[k][0] = 1
    np.testing.assert_array_equal(b.bam_id, np.arange(b.n_reads))
    np.testing.assert_array_equal(b.is_first, np.arange(b.n_reads) % 2 == 0)
    other = loop.read_batch(generate.sample(SMALL, 4, generate.WINDOW, 3))
    assert other.bam_id is b.bam_id and not np.shares_memory(other.start, b.start)


# -- the reservoir of answers ---------------------------------------------------------

def _reservoir(seed, n, k):
    kept = []
    for i in range(n):
        slot = judge.reservoir_slot(seed, i, k)
        if slot is not None:
            kept[slot:slot + 1] = [i]
    return sorted(kept)


@pytest.mark.parametrize("k", [1, 3])
def test_reservoir_keeps_k_drawn_from_the_seed(k):
    assert _reservoir(7, 2, 3) == [0, 1]
    a = _reservoir(7, 50, k)
    assert a == _reservoir(7, 50, k) and len(a) == k and all(0 <= i < 50 for i in a)
    picks = Counter(i for seed in range(600) for i in _reservoir(seed, 12, k))
    expected = 600 * k / 12
    assert set(picks) == set(range(12))
    assert min(picks.values()) > 0.6 * expected and max(picks.values()) < 1.4 * expected


class _Stub:
    """A solver that keeps every read, on the CPU."""

    def solve(self, m, batch):
        return np.arange(batch.n_reads)


def _cell(reads, check_samples):
    """A cell of the stub's with these reads: the loop reads the making from them."""
    cell = spec.Cell("sarscov2-artic-clinical.qmcp")
    cell.config = {**cell.config, "reads": reads, "max_coverage": 5}
    cell.traffic = {**cell.traffic, "check_samples": check_samples}
    return cell


@pytest.mark.parametrize("making", ["default", "genome_scale"])
@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_the_loop_keeps_exactly_the_answers_the_judge_checks(seed, making):
    """Whatever the making, the loop holds no more than ``check_samples``
    answers: the reservoir, which the judge then checks whole."""
    import time

    from drive_tiny import TINY as ARTIC

    cell = _cell(SMALL if making == "genome_scale" else ARTIC, 2)
    run = loop.measure(cell, seed, 0.02, False, lambda name: _Stub(), time.perf_counter(),
                       cuda=False)
    done = len(run.reads)
    assert done >= 3 and len(run.making) == run.attempted
    assert sorted(run.answers) == _reservoir(seed, done, 2)
    assert judge.checked_indices(seed, run.answers, 2) == sorted(run.answers)
