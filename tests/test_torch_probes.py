"""The port's probes (``genome_downsampler_tpu_torch.scripts.bench_*``, the
counterparts of the JAX package's root scripts) on the CPU, at small cuts
of their cases: each ``run("cpu", ...)`` on the plain twins holds its own
checks, and what it computed is held against the JAX package on the same
seeded inputs: kernel A's counts against ``sweep_counts``, the blocked
solves' per-end counts and rounds against ``blocked_windowed_sweep`` in
interpret mode, the solvers' read sets against the JAX solvers, the BAM
engine's reads and bytes against the JAX ``read_bam`` and ``write_bam``,
the sharded QMCP's output against the JAX ``run_sharded``. Every
comparison is integer equality. Each probe's JSON keys are checked, and
each ``main`` raises without a card.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_downsampler_tpu.config import BamApiConfig as JaxConfig
from genome_downsampler_tpu.core.readbatch import ReadBatch as JaxBatch
from genome_downsampler_tpu.io import bam as jax_bam
from genome_downsampler_tpu.ops import coverage as jax_cov
from genome_downsampler_tpu.ops import pallas_blocked as jax_blocked
from genome_downsampler_tpu.parallel import sharded_io as jax_sio
from genome_downsampler_tpu.solvers import device_sweep as jax_sweep
from genome_downsampler_tpu.solvers.blocked_sweep import BlockedWindowedMcpSolver as JaxBlocked
from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform as jax_reads
from genome_downsampler_tpu_torch.config import BamApiConfig
from genome_downsampler_tpu_torch import scripts
from genome_downsampler_tpu_torch.io import bam
from genome_downsampler_tpu_torch.scripts import (
    bench_blocked,
    bench_config4_probe,
    bench_e2e_quick,
    bench_io,
    bench_kernel,
    bench_sharded_qmcp,
    bench_w_scaling,
)
from genome_downsampler_tpu_torch.solvers.native_greedy import native_greedy_select

from tests.test_torch_sharded import JAX_CFG

CFG = BamApiConfig(min_mapq=0, min_seq_length=0)


def _record(monkeypatch, module, name):
    """Wrap ``module.name`` so each call's arguments and result are kept,
    as numpy, in the returned list."""
    calls = []
    real = getattr(module, name)

    def recorded(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out))
        return out

    monkeypatch.setattr(module, name, recorded)
    return calls


def _np(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _keys(res, *keys):
    assert set(keys) <= set(res), sorted(set(keys) - set(res))
    json.dumps(res)  # the printed line is JSON
    assert res["ok"] is True and res["device"] == "cpu"


# kernel A: 5,000 pairs over 1,000 bases (1,500x), n = 1,024


def test_bench_kernel_counts_equal_jax_sweep_counts(monkeypatch):
    calls = _record(monkeypatch, bench_kernel, "dense_sweep_counts")
    pairs, genome, n, L = 5_000, 1_000, 1_024, bench_kernel.L
    res = bench_kernel.run("cpu", pairs, genome=genome, n=n, reps=1, log=lambda *a: None)
    _keys(res, "pairs", "reads", "n", "L", "M", "matches_scan", "read_set_equal",
          "selected", "oracle", "ms", "ns_per_position", "laps")
    assert res["matches_scan"] and res["read_set_equal"] and len(res["ms"]) == 4
    assert res["selected"] < res["reads"]

    batch = jax_reads(np.random.default_rng(bench_kernel.SEED), pairs, genome, 150)
    arrays, valid = batch.padded(4096)
    start, endv = jnp.asarray(arrays["start"]), jnp.asarray(arrays["end"])
    w = jnp.asarray(valid).astype(jnp.int32)
    rows = jax_sweep.build_start_rows(start, endv - start + 1, w, n, L)
    cov = jax_cov.coverage_from_intervals(start, endv, n, w)
    z = jnp.zeros(L, jnp.int32)
    refs = {m: (np.asarray(jax_cov.capped_coverage(cov, m)),
                np.asarray(jax_sweep.sweep_counts(
                    rows, jax_cov.capped_coverage(cov, m), z, z, L)[0]))
            for m in bench_kernel.MS}
    seen = set()
    for args, _, out in calls:
        target = _np(args[1])[0]
        m = next(m for m, (t, _) in refs.items() if np.array_equal(t, target))
        np.testing.assert_array_equal(_np(out[0])[0], refs[m][1])
        seen.add(m)
    assert seen == set(bench_kernel.MS)
    np.testing.assert_array_equal(_np(calls[0][0][0])[0], np.asarray(rows))


# the BAM engine: 3,000 pairs


def test_bench_io_reads_and_bytes_equal_jax(tmp_path):
    res = bench_io.run("cpu", 3_000, workdir=tmp_path, log=lambda *a: None)
    _keys(res, "pairs", "records", "bam_mb", "synth_s", "read", "write", "written",
          "reads_equal", "writes_equal")
    assert set(res["read"]) == set(res["write"]) == {"1", "4", "8"}
    path = tmp_path / "in.bam"
    got, fo, single = bam.read_bam(path, CFG)
    ref, rfo, rsingle = jax_bam.read_bam(path, JaxConfig(min_mapq=0, min_seq_length=0))
    for f in ("bam_id", "start", "end", "quality", "seq_length", "is_first"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    np.testing.assert_array_equal(fo, rfo)
    sel = np.arange(0, res["records"], 2, dtype=np.int64)
    assert jax_bam.write_bam(path, tmp_path / "jax.bam", sel) == res["written"]
    for t in bench_io.THREADS:
        assert (tmp_path / f"out{t}.bam").read_bytes() == (tmp_path / "jax.bam").read_bytes()


def _jax_blocked_solves(calls, chunk=256):
    """Each recorded ``blocked_windowed_sweep`` call run by the JAX
    package's, in interpret mode, on the same inputs: its sel and rounds
    equal to the port's."""
    for args, kw, (sel, rounds) in calls:
        packed, counts, target, W, B, L = args
        ref, ref_rounds = jax_blocked.blocked_windowed_sweep(
            jnp.asarray(_np(packed)), jnp.asarray(_np(counts)), jnp.asarray(_np(target)),
            W, B, L, chunk=chunk, interpret=True, seed_blocks=kw.get("seed_blocks", 8))
        np.testing.assert_array_equal(_np(sel), np.asarray(ref))
        assert rounds == int(ref_rounds)


# the blocked solve alone: sars cut to 8,000 pairs over 2,048 bases (W=2,
# 8 blocks a window: no seed pass) and ecoli-small cut to 1,000 pairs over
# 2,560 bases (10 blocks a window: a seed pass)
@pytest.mark.parametrize("scale,pairs,genome", [("sars", 8_000, 2_048),
                                                ("ecoli-small", 1_000, 2_560)])
def test_bench_blocked_equals_jax_blocked_sweep(monkeypatch, scale, pairs, genome):
    calls = _record(monkeypatch, scripts, "blocked_windowed_sweep")
    res = bench_blocked.run("cpu", scale, n_windows=2, block=128, pairs=pairs,
                            genome=genome, reps=1, log=lambda *a: None)
    _keys(res, "scale", "pairs", "reads", "n", "M", "W", "B", "L", "win", "nbw", "cap",
          "packed_mb", "pass_ms", "ns_per_position", "solve_ms", "rounds", "selected",
          "oracle", "read_set_equal", "valid", "laps")
    assert res["selected"] == res["oracle"] < res["reads"]
    assert len(calls) == 2  # a warm solve and a timed one
    _jax_blocked_solves(calls[:1])
    assert calls[0][2][1] == res["rounds"]


# W against rounds: 2,000 reads at 60x (5,000 bases) at W = 2 (B = 256) and
# W = 4 (B = 128), each from zero seed blocks and 8 (10 blocks a window)
def test_bench_w_scaling_equals_jax_blocked_sweep(monkeypatch):
    calls = _record(monkeypatch, scripts, "blocked_windowed_sweep")
    res = bench_w_scaling.run("cpu", 2_000, ((2, None), (4, 128)), reps=1,
                              log=lambda *a: None)
    _keys(res, "reads", "n", "M", "cov", "seed", "L", "host_greedy_s",
          "host_greedy_warm_s", "oracle", "ws")
    assert [(w["W"], w["B"]) for w in res["ws"]] == [(2, 256), (4, 128)]
    for w in res["ws"]:
        assert set(w) >= {"cap", "nbw", "win", "pack_s", "pass_ms", "ns_per_position",
                          "solves"}
        assert w["nbw"] > 8
        assert set(w["solves"]) == {"seed0", "seed8"}
        assert all(s["exact"] and s["selected"] == res["oracle"] for s in w["solves"].values())
    # the warm call of each (W, seed blocks); B = 256 packs caps of 256, else 128
    firsts = calls[0::2]
    assert [(c[0][3], c[1]["seed_blocks"]) for c in firsts] == [(2, 0), (2, 8), (4, 0), (4, 8)]
    _jax_blocked_solves(firsts[:2], chunk=256)
    _jax_blocked_solves(firsts[2:], chunk=128)


def _solves(monkeypatch, module, name):
    """Record every read set the solver class ``module.name`` returns."""
    out = []
    real = getattr(module, name)

    class Recorded(real):
        def solve(self, m, batch):
            sel = super().solve(m, batch)
            out.append((m, batch, sel))
            return sel

    monkeypatch.setattr(module, name, Recorded)
    return out


def _jax_batch(b):
    return JaxBatch(bam_id=b.bam_id, start=b.start, end=b.end, quality=b.quality,
                    seq_length=b.seq_length, is_first=b.is_first,
                    ref_genome_length=b.ref_genome_length)


# config-4's probe cut to 4,000 reads over 12,000 bases (50x), M=20, 2 reps
def test_bench_config4_probe_equals_jax_solver_and_greedy(monkeypatch):
    solves = _solves(monkeypatch, bench_config4_probe, "BlockedWindowedMcpSolver")
    res = bench_config4_probe.run("cpu", 4_000, 12_000, 20, 2, log=lambda *a: None)
    _keys(res, "reads", "n", "M", "coverage", "reps")
    assert [r["rep"] for r in res["reps"]] == [0, 1] and len(solves) == 2
    for r in res["reps"]:
        assert set(r) == {"rep", "host_greedy_s", "solve_s", "selected", "oracle",
                          "read_set_equal", "stats"}
        assert set(r["stats"]["phases_s"]) == {"pack", "h2d", "sweep", "select", "d2h",
                                               "bit test"}
    starts = [bench_config4_probe.rep_starts(4_000, 12_000, rep) for rep in (0, 1)]
    assert not np.array_equal(*starts)
    for (m, batch, sel), s in zip(solves, starts):
        np.testing.assert_array_equal(batch.start, s)
        ref = JaxBlocked().solve(m, _jax_batch(batch))
        np.testing.assert_array_equal(sel, ref)
        np.testing.assert_array_equal(sel, native_greedy_select(s, s + 149, 12_000, m))


# the production solver at 6,000 reads (15,000 bases: the dense engine)
def test_bench_e2e_quick_equals_jax_solver_and_greedy(monkeypatch):
    solves = _solves(monkeypatch, bench_e2e_quick, "McpDeviceSweepSolver")
    res = bench_e2e_quick.run("cpu", 6_000, log=lambda *a: None)
    _keys(res, "reads", "n", "M", "seed", "selected", "oracle", "host_cold_s",
          "host_warm_s", "device_cold_s", "cold_read_set_equal", "warm", "stats")
    assert len(res["warm"]) == bench_e2e_quick.WARM and len(solves) == 1 + bench_e2e_quick.WARM
    assert res["stats"]["engine"] == "dense"
    m, batch, _ = solves[0]
    ref = jax_sweep.McpDeviceSweepSolver().solve(m, _jax_batch(batch))
    oracle = native_greedy_select(batch.start, batch.end, batch.ref_genome_length, m)
    for _, _, sel in solves:
        np.testing.assert_array_equal(sel, ref)
        np.testing.assert_array_equal(sel, oracle)


# sharded QMCP: 4,000 reads over 16,384 bases, M=50, two gloo ranks
def test_bench_sharded_qmcp_equals_jax_run_sharded(tmp_path):
    out = tmp_path / "torch.bam"
    res = bench_sharded_qmcp.run("cpu", 4_000, genome=16_384, cache=tmp_path,
                                 out_path=out, timeout=120, log=lambda *a: None)
    _keys(res, "reads", "genome", "M", "halo", "max_span", "ranks", "wall_s",
          "merged_equal", "valid")
    (path,) = tmp_path.glob("config4_*.bam")
    ref_out = tmp_path / "jax.bam"
    ref = jax_sio.run_sharded(path, 50, JAX_CFG, ref_out, halo=bench_sharded_qmcp.HALO,
                              max_span=bench_sharded_qmcp.MAX_SPAN, algorithm="qmcp-cpu")
    assert out.read_bytes() == ref_out.read_bytes()
    for r in res["ranks"]:
        assert r["rc"] == 0 and r["merged"] == len(ref)
        assert r["qmcp_stats"]["total_reads"] == 4_000 and r["gathered_frac"] < 0.6


@pytest.mark.parametrize("module,argv", [
    (bench_kernel, ["0.001"]), (bench_io, ["0.001"]), (bench_blocked, ["sars"]),
    (bench_config4_probe, ["0.01", "0.05"]), (bench_e2e_quick, ["0.01"]),
    (bench_w_scaling, ["0.01", "8"]), (bench_sharded_qmcp, ["0.01"]),
])
def test_probe_main_raises_without_a_card(monkeypatch, module, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)
