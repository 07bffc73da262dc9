"""The port's host-sharded pipeline (``parallel.sharded_io.run_sharded``)
against the JAX package's on the conftest's 8-device virtual mesh: merged
voffsets and output bytes equal, dense and blocked engines, at one rank
in-process and two ranks as gloo workers; the QMCP path; the halo checks
with the JAX messages."""

import json

import numpy as np
import pytest

from genome_downsampler_tpu.config import BamApiConfig as JaxConfig
from genome_downsampler_tpu.parallel import sharded_io as jax_sio
from genome_downsampler_tpu.testing.bam_writer import write_test_bam
from genome_downsampler_tpu_torch.config import BamApiConfig
from genome_downsampler_tpu_torch.parallel import sharded_io
from genome_downsampler_tpu_torch.testing.mesh_worker import spawn_ranks

from tests.test_region_io import make_bounded_insert_batch

CFG = BamApiConfig(min_mapq=0, min_seq_length=0)
JAX_CFG = JaxConfig(min_mapq=0, min_seq_length=0)
TIMEOUT = 120  # seconds a two-rank case may take before its ranks are killed
ENGINES = {"dense": {"engine": "dense"},
           "blocked": {"engine": "blocked", "block": 64, "windows_per_device": 2}}


def _bam(tmp_path, pairs, max_insert, seed, name="in.bam"):
    batch = make_bounded_insert_batch(
        pairs=pairs, n=16_384, read_len=100, max_insert=max_insert, seed=seed
    )
    path = tmp_path / name
    write_test_bam(path, batch, coordinate_sorted=True, make_index=True)
    return path


@pytest.fixture
def sorted_indexed_bam(tmp_path):
    """tests/test_sharded_io.py's input: 2,000 bounded-insert pairs over
    16,384 bases, seed 11."""
    return _bam(tmp_path, 2000, 600, 11)


def test_bam_genome_length(sorted_indexed_bam):
    assert sharded_io.bam_genome_length(sorted_indexed_bam) == \
        jax_sio.bam_genome_length(sorted_indexed_bam) == 16_384


@pytest.mark.parametrize("engine", ["dense", "blocked"])
def test_run_sharded_one_rank_equals_jax(sorted_indexed_bam, tmp_path, engine):
    kw = dict(halo=1024, max_span=128, **ENGINES[engine])
    ref_out, out = tmp_path / "jax.bam", tmp_path / "torch.bam"
    ref = jax_sio.run_sharded(sorted_indexed_bam, 6, JAX_CFG, ref_out, **kw)
    stats = {}
    merged = sharded_io.run_sharded(sorted_indexed_bam, 6, CFG, out, device="cpu",
                                    stats=stats, **kw)
    np.testing.assert_array_equal(merged, ref)
    assert out.read_bytes() == ref_out.read_bytes()
    assert stats["engine"] == engine and stats["ranks"] == 1
    assert set(stats["laps_s"]) == {"read", "pack", "solve", "reconstruct", "gather",
                                    "write"}


@pytest.mark.parametrize("engine", ["dense", "blocked"])
def test_run_sharded_two_ranks_equal_jax(sorted_indexed_bam, tmp_path, engine):
    kw = dict(halo=1024, max_span=128, **ENGINES[engine])
    ref_out, out = tmp_path / "jax.bam", tmp_path / "torch.bam"
    ref = jax_sio.run_sharded(sorted_indexed_bam, 6, JAX_CFG, ref_out, **kw)
    rcs, outs, res = spawn_ranks(
        "run_sharded", 2, tmp_path / "ranks", timeout=TIMEOUT,
        params={"path": str(sorted_indexed_bam), "m": 6, "out_path": str(out), **kw},
    )
    for r, (rc, o) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {r} failed:\n{o[-3000:]}"
    for r in res:
        np.testing.assert_array_equal(r["merged"], ref)
    assert out.read_bytes() == ref_out.read_bytes()
    stats = [json.loads(str(r["stats"])) for r in res]
    assert [s["rank"] for s in stats] == [0, 1]
    assert stats[0]["rounds"] == stats[1]["rounds"] >= 1
    # rank 0 ships its last window's carry to rank 1 each round after the first
    assert stats[0]["messages"] >= stats[0]["rounds"] - 1


def test_qmcp_one_rank_equals_jax(tmp_path):
    """tests/test_sharded_qmcp.py's single-process case: 1,500 pairs, seed
    7, M=4."""
    bam = _bam(tmp_path, 1500, 500, 7)
    ref_out, out = tmp_path / "jax.bam", tmp_path / "torch.bam"
    ref = jax_sio.run_sharded(bam, 4, JAX_CFG, ref_out, halo=1024, max_span=128,
                              algorithm="qmcp-cpu")
    merged = sharded_io.run_sharded(bam, 4, CFG, out, halo=1024, max_span=128,
                                    algorithm="qmcp-cpu", device="cpu")
    np.testing.assert_array_equal(merged, ref)
    assert out.read_bytes() == ref_out.read_bytes()
    assert sharded_io.LAST_QMCP_STATS == jax_sio.LAST_QMCP_STATS


def test_qmcp_two_ranks_equal_one(tmp_path):
    """The JAX suite's two-process QMCP case (1,500 pairs, seed 12, M=4):
    output bytes equal to one rank's, the gathered footprint under 60% of
    replicating every read's tuple."""
    bam = _bam(tmp_path, 1500, 500, 12)
    expected, out = tmp_path / "expected.bam", tmp_path / "out.bam"
    sharded_io.run_sharded(bam, 4, CFG, expected, halo=1024, max_span=128,
                           algorithm="qmcp-cpu", device="cpu")
    rcs, outs, res = spawn_ranks(
        "run_sharded", 2, tmp_path / "ranks", timeout=TIMEOUT,
        params={"path": str(bam), "m": 4, "out_path": str(out), "halo": 1024,
                "max_span": 128, "algorithm": "qmcp-cpu"},
    )
    for r, (rc, o) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {r} failed:\n{o[-3000:]}"
    assert out.read_bytes() == expected.read_bytes()
    for r in res:
        st = json.loads(str(r["qmcp_stats"]))
        assert st["gathered_bytes"] / st["replicated_tuple_bytes_r3"] < 0.6, st


def test_grade_remap_equals_jax(tmp_path):
    """GRADE: the quality remap uses the all-reduced MAPQ range; the QMCP
    output equals the JAX package's."""
    bam = _bam(tmp_path, 1500, 500, 7)
    (tmp_path / "amp.bed").write_text("ref1\t0\t120\tA1_LEFT\nref1\t3880\t4000\tA1_RIGHT\n")
    (tmp_path / "amp.tsv").write_text("A1_LEFT\tA1_RIGHT\n")
    amp = dict(min_mapq=0, min_seq_length=0, bed_path=tmp_path / "amp.bed",
               tsv_path=tmp_path / "amp.tsv")
    from genome_downsampler_tpu.config import AmpliconBehaviour as JaxBehaviour
    from genome_downsampler_tpu_torch.config import AmpliconBehaviour

    ref_out, out = tmp_path / "jax.bam", tmp_path / "torch.bam"
    ref = jax_sio.run_sharded(bam, 4, JaxConfig(amplicon_behaviour=JaxBehaviour.GRADE, **amp),
                              ref_out, halo=1024, max_span=128, algorithm="qmcp-cpu")
    merged = sharded_io.run_sharded(
        bam, 4, BamApiConfig(amplicon_behaviour=AmpliconBehaviour.GRADE, **amp), out,
        halo=1024, max_span=128, algorithm="qmcp-cpu", device="cpu")
    np.testing.assert_array_equal(merged, ref)
    assert out.read_bytes() == ref_out.read_bytes()


def test_two_ranks_too_small_halo_fails_loudly(tmp_path):
    """max_insert 600 >> halo 256: boundary pairs are dropped, and the run
    raises the JAX package's RuntimeError instead of diverging."""
    bam = _bam(tmp_path, 1500, 600, 13)
    rcs, outs, _ = spawn_ranks(
        "run_sharded", 2, tmp_path / "ranks", timeout=TIMEOUT,
        params={"path": str(bam), "m": 4, "out_path": str(tmp_path / "out.bam"),
                "halo": 256, "max_span": 128, "algorithm": "qmcp-cpu"},
    )
    assert any(rcs), "too-small halo did not fail"
    text = "\n".join(outs)
    assert "RuntimeError: rank " in text
    assert ("boundary pair(s) dropped by the region read touch the owned window "
            in text)
    assert "halo=256 is too small — the widest offending pair needs >= " in text
    assert not (tmp_path / "out.bam").exists()


def test_allow_boundary_drops_warns_and_continues(tmp_path):
    bam = _bam(tmp_path, 1500, 600, 13)
    rcs, outs, res = spawn_ranks(
        "run_sharded", 2, tmp_path / "ranks", timeout=TIMEOUT,
        params={"path": str(bam), "m": 4, "halo": 256, "max_span": 128,
                "algorithm": "qmcp-cpu", "allow_boundary_drops": True},
    )
    assert rcs == [0, 0], outs
    assert "allow_boundary_drops=True: continuing" in "\n".join(outs)


@pytest.mark.parametrize("halo,max_span", [(100, 128), (255, 128), (511, 256)])
def test_small_halo_value_error_matches_jax(sorted_indexed_bam, halo, max_span):
    with pytest.raises(ValueError) as ours:
        sharded_io.run_sharded(sorted_indexed_bam, 6, CFG, None, halo=halo,
                               max_span=max_span, device="cpu")
    with pytest.raises(ValueError) as ref:
        jax_sio.run_sharded(sorted_indexed_bam, 6, JAX_CFG, None, halo=halo,
                            max_span=max_span)
    assert str(ours.value) == str(ref.value)


def test_qmcp_refuses_max_coverage_beyond_the_metadata(sorted_indexed_bam):
    with pytest.raises(ValueError) as ours:
        sharded_io.run_sharded(sorted_indexed_bam, 1 << 20, CFG, None, halo=1024,
                               max_span=128, algorithm="qmcp-cpu", device="cpu")
    with pytest.raises(ValueError) as ref:
        jax_sio.run_sharded(sorted_indexed_bam, 1 << 20, JAX_CFG, None, halo=1024,
                            max_span=128, algorithm="qmcp-cpu")
    assert str(ours.value) == str(ref.value)


def test_auto_engine_and_quality_names(sorted_indexed_bam):
    """"auto" is dense while a rank's rows cost win * L * 4 <= 256 MiB (16
    KiB here); the QMCP names are the port's."""
    stats = {}
    sharded_io.run_sharded(sorted_indexed_bam, 6, CFG, None, halo=1024, max_span=128,
                           device="cpu", stats=stats)
    assert stats["engine"] == "dense"
    assert sharded_io.QUALITY_ALGOS == ("qmcp-cpu", "qmcp-cuda", "qmcp-lp-cpu",
                                        "qmcp-sweep-cuda")


def test_owned_reconstruct_takes_reads_from_the_left_window():
    """A rank past the first owns reads that start left of its window. From
    200,000 reads the host C reconstruct takes over, and it refuses negative
    starts: in window coordinates (the JAX package's) it raises; in the
    frame shifted by max_span it picks what the numpy lexsort picks."""
    from genome_downsampler_tpu.solvers.device_sweep import (
        reconstruct_selection as jax_reconstruct,
    )

    rng = np.random.default_rng(21)
    lo_w, hi_w, L = 50_000, 150_000, 128
    start = rng.integers(lo_w - L + 1, hi_w, 260_000)
    end = np.minimum(start + rng.integers(0, L, start.shape[0]), hi_w + 500)
    own = np.flatnonzero((end >= lo_w) & (end < hi_w))
    assert own.shape[0] >= 200_000 and (start[own] < lo_w).any()
    bucket = np.bincount(end[own] - lo_w, minlength=hi_w - lo_w)
    sel_local = rng.integers(0, bucket + 1)
    with pytest.raises(ValueError, match="gd_reconstruct"):
        jax_reconstruct(start[own] - lo_w, end[own] - lo_w, sel_local)
    # the lexsort path (below 200,000 reads) on window coordinates
    order = np.lexsort((np.arange(own.shape[0]), start[own], end[own]))
    e_sorted = end[own][order]
    first = np.concatenate([[True], e_sorted[1:] != e_sorted[:-1]])
    idx = np.arange(order.shape[0])
    rank = idx - np.maximum.accumulate(np.where(first, idx, 0))
    want = own[np.sort(order[sel_local[e_sorted - lo_w] > rank])]
    got = sharded_io._reconstruct_owned(start, end, lo_w, hi_w, sel_local, L)
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] == int(sel_local.sum())
