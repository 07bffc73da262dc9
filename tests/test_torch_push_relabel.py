"""The port's push-relabel solver (``quasi-mcp-flow-cuda``) against the JAX
package's ``solvers/push_relabel.py``, on the CPU: the arc table, the
distance closure and the whole solve at superstep caps that freeze
different intermediate states, bit for bit; the JAX suite's feasibility
and determinism tests on the port; the registry and the CLI. Tolerance 0
throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_downsampler_tpu.cli.main import main as jax_main
from genome_downsampler_tpu.ops import coverage as jax_cov
from genome_downsampler_tpu.solvers import push_relabel as jax_pr
from genome_downsampler_tpu.testing.bam_writer import write_test_bam_fast
from genome_downsampler_tpu_torch.cli.main import main
from genome_downsampler_tpu_torch.ops.coverage import (
    capped_coverage,
    coverage_from_intervals,
)
from genome_downsampler_tpu_torch.solvers import push_relabel, registry
from genome_downsampler_tpu_torch.solvers.push_relabel import (
    BIG,
    QuasiMcpPushRelabelSolver,
)
from genome_downsampler_tpu_torch.testing.fixtures import (
    SMALL_EXAMPLE_MAX_COVERAGE,
    small_example_batch,
)
from genome_downsampler_tpu_torch.testing.reads_gen import rand_reads_uniform


def np_coverage(start, end, n, sel=None):
    cov = np.zeros(n + 1, np.int64)
    s = start if sel is None else start[sel]
    e = end if sel is None else end[sel]
    np.add.at(cov, np.clip(s, 0, n), 1)
    np.add.at(cov, np.clip(e + 1, 0, n), -1)
    return np.cumsum(cov)[:n]


def assert_valid(batch, sel, m):
    cov_in = np_coverage(batch.start, batch.end, batch.ref_genome_length)
    cov_out = np_coverage(batch.start, batch.end, batch.ref_genome_length, sel)
    bad = np.nonzero(np.minimum(cov_in, m) > cov_out)[0]
    assert bad.size == 0, f"coverage validity violated at {bad.size} positions, first {bad[:5]}"


def _case(name):
    """(batch, M, pad_multiple): the JAX suite's small example and random
    inputs (tests/test_push_relabel.py)."""
    if name == "small_example":
        return small_example_batch(), SMALL_EXAMPLE_MAX_COVERAGE, 32
    if name.startswith("seed"):  # test_random_small_feasible's seeds 0 and 1
        seed = int(name[4:])
        return rand_reads_uniform(np.random.default_rng(seed), 150, 600, 40), (3, 5)[seed], 512
    raise ValueError(name)


@pytest.mark.parametrize("reads,n,pad", [(16, 11, 32), (150, 600, 512), (7, 600, 16),
                                         (300, 900, 300)])
def test_build_arc_table_matches_jax(reads, n, pad):
    """All five columns, with padded reads (start 0, end -1) and n > R."""
    rng = np.random.default_rng(reads)
    start = rng.integers(0, n - 5, reads)
    end = np.minimum(start + rng.integers(0, 40, reads), n - 1)
    R = -(-reads // pad) * pad
    s = np.zeros(R, np.int32)
    e = np.full(R, -1, np.int32)
    s[:reads], e[:reads] = start, end
    ref = jax_pr._build_arc_table(jnp.asarray(s), jnp.asarray(e), n, R)
    got = push_relabel.build_arc_table(torch.from_numpy(s), torch.from_numpy(e), n, R)
    for col in ("tails", "heads", "kind", "slot", "seg_start"):
        np.testing.assert_array_equal(getattr(got, col).numpy(), np.asarray(getattr(ref, col)),
                                      err_msg=col)
    # `flat` is each arc's position in the assembly order: kind offset + slot
    off = np.cumsum([0, R, R, n, n, n + 1, n + 1])
    np.testing.assert_array_equal(got.flat.numpy(),
                                  off[got.kind.numpy()] + got.slot.numpy())


def _closure_inputs(seed, chain):
    rng = np.random.default_rng(seed)
    n, r = 400, 260
    start = rng.integers(0, n - 3, r).astype(np.int32)
    end1 = np.minimum(start + rng.integers(1, 60, r), n).astype(np.int32)
    fr = rng.random(r) < 0.4
    valid = rng.random(r) < 0.9
    rf, rb = valid & ~fr, valid & fr
    seeds = rng.random(n + 1)
    d = np.where(seeds < 0.03, 1, np.where(seeds < 0.06, rng.integers(2, 90, n + 1), BIG))
    if chain == "zero":
        f_chain = np.zeros(n, np.int32)
    elif chain == "positive":
        f_chain = rng.integers(1, 5, n)
    else:  # runs of positive flow between zeros
        f_chain = np.where(rng.random(n) < 0.15, 0, rng.integers(1, 5, n)) * (
            (np.arange(n) // 37) % 3 != 0)
    return (d.astype(np.int32), start, end1, rf, rb, f_chain.astype(np.int32))


@pytest.mark.parametrize("chain", ["zero", "positive", "runs"])
@pytest.mark.parametrize("seed", [0, 1])
def test_dist_closure_matches_jax(seed, chain):
    args = _closure_inputs(seed, chain)
    ref = jax_pr._dist_closure(*(jnp.asarray(a) for a in args))
    got, rounds = push_relabel.dist_closure(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.int32 and rounds >= 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _solve_inputs(name):
    batch, m, pad = _case(name)
    arrays, v = batch.padded(pad)
    s, e = arrays["start"], arrays["end"]
    n = batch.ref_genome_length
    cov = coverage_from_intervals(torch.from_numpy(s), torch.from_numpy(e), n,
                                  torch.from_numpy(v).to(torch.int32))
    capped = capped_coverage(cov, m)
    jcov = jax_cov.coverage_from_intervals(jnp.asarray(s), jnp.asarray(e), n,
                                           jnp.asarray(v).astype(jnp.int32))
    jcapped = jax_cov.capped_coverage(jcov, m)
    np.testing.assert_array_equal(capped.numpy(), np.asarray(jcapped))
    return s, e, v, capped, jcapped, n


@pytest.mark.parametrize("cap", [1, 2, 3, 24, 25, 26, 51, 200_000])
@pytest.mark.parametrize("name", ["small_example", "seed0", "seed1"])
def test_push_relabel_solve_matches_jax_at_caps(name, cap):
    """Each cap stops the loop at another state (mid-block, at a relabel,
    just after one, at convergence): the selection, the steps and the
    excess left equal JAX's."""
    s, e, v, capped, jcapped, n = _solve_inputs(name)
    ref_sel, ref_steps, ref_left = jax_pr.push_relabel_solve(
        jnp.asarray(s), jnp.asarray(e), jnp.asarray(v), jcapped, n, max_supersteps=cap)
    stats = {}
    sel, steps, left = push_relabel.push_relabel_solve(
        torch.from_numpy(s), torch.from_numpy(e), torch.from_numpy(v), capped, n,
        max_supersteps=cap, stats=stats)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(ref_sel))
    assert (steps, left) == (int(ref_steps), int(ref_left))
    assert stats["supersteps"] == steps
    assert stats["global_relabels"] == -(-max(steps, 1) // 25)
    assert stats["bodies"] >= steps
    assert stats["host_syncs"] == stats["closure_rounds"] + stats["global_relabels"] + 2


def test_small_example_feasible():
    batch = small_example_batch()
    sel = QuasiMcpPushRelabelSolver("cpu", pad_multiple=32).solve(
        SMALL_EXAMPLE_MAX_COVERAGE, batch)
    assert_valid(batch, sel, SMALL_EXAMPLE_MAX_COVERAGE)


@pytest.mark.parametrize("seed,m", [(0, 3), (1, 5), (2, 2), (3, 8)])
def test_random_small_feasible(seed, m):
    batch = rand_reads_uniform(np.random.default_rng(seed), 150, 600, 40)
    sel = QuasiMcpPushRelabelSolver("cpu", pad_multiple=512).solve(m, batch)
    assert_valid(batch, sel, m)


def test_medium_feasible_and_equal_to_jax():
    batch = rand_reads_uniform(np.random.default_rng(5), 500, 1200, 60)
    solver = QuasiMcpPushRelabelSolver("cpu", pad_multiple=1024)
    sel = solver.solve(10, batch)
    assert_valid(batch, sel, 10)
    assert len(sel) < batch.n_reads  # downsampling actually happened
    jax_sel = jax_pr.QuasiMcpPushRelabelSolver(pad_multiple=1024).solve(10, batch)
    np.testing.assert_array_equal(sel, jax_sel)
    stats = solver.last_stats
    assert stats["engine"] == "torch" and stats["supersteps"] > 0
    assert set(stats["laps_s"]) == {"coverage", "arcs", "relabel", "supersteps", "select"}


def test_superstep_cap_raises_not_silent():
    """An exhausted superstep budget is a hard error, not an infeasible
    selection."""
    batch = rand_reads_uniform(np.random.default_rng(5), 500, 1200, 60)
    solver = QuasiMcpPushRelabelSolver("cpu", pad_multiple=1024, max_supersteps=1)
    with pytest.raises(RuntimeError, match="did not converge"):
        solver.solve(10, batch)


def test_deterministic():
    batch = rand_reads_uniform(np.random.default_rng(9), 300, 1000, 60)
    solver = QuasiMcpPushRelabelSolver("cpu", pad_multiple=1024)
    np.testing.assert_array_equal(solver.solve(4, batch), solver.solve(4, batch))


def test_registry_has_quasi_mcp_flow_cuda_and_it_needs_a_card(monkeypatch):
    reg = registry.default_registry()
    assert "quasi-mcp-flow-cuda" in reg.get_names()
    assert not reg.uses_quality_of_reads("quasi-mcp-flow-cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reg.get("quasi-mcp-flow-cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QuasiMcpPushRelabelSolver("cuda")


def test_cli_quasi_mcp_flow_records_equal_jax_cli(tmp_path, monkeypatch):
    """BAM -> BAM through both CLIs: the port's solver built by the
    registry's factory on the CPU, since there is no card."""
    from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform as jax_reads

    src = tmp_path / "in.bam"
    write_test_bam_fast(src, jax_reads(np.random.default_rng(4), 600, 2500, 100))
    flags = ["-l", "0", "-q", "0"]
    jax_out, out = tmp_path / "jax.bam", tmp_path / "torch.bam"
    assert jax_main([str(src), "12", "-o", str(jax_out), "-a", "quasi-mcp-flow-tpu",
                     *flags]) == 0
    monkeypatch.setattr(registry, "_make_quasi_flow_cuda",
                        lambda: QuasiMcpPushRelabelSolver("cpu"))
    assert main([str(src), "12", "-o", str(out), "-a", "quasi-mcp-flow-cuda", *flags]) == 0
    assert out.read_bytes() == jax_out.read_bytes()
