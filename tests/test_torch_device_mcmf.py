"""The port's exact weighted solver (``qmcp-cuda``) against the JAX
package's ``solvers/device_mcmf.py``, on the CPU: the host copies, the SSP
kernel's plain twin against the JAX ``solve_loop`` (bit for bit in flows,
supply, status and phases), the solver against the LP oracle, its size
dispatch, and the errors it raises. Tolerance 0 throughout."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_downsampler_tpu.solvers import device_mcmf as jax_mcmf
from genome_downsampler_tpu.testing.fixtures import (
    small_example_batch as jax_small_example_batch,
)
from genome_downsampler_tpu_torch.core.readbatch import ReadBatch
from genome_downsampler_tpu_torch.ops import ssp
from genome_downsampler_tpu_torch.solvers import device_mcmf
from genome_downsampler_tpu_torch.solvers.native_mcmf import mcmf_select_convex
from genome_downsampler_tpu_torch.solvers.registry import default_registry
from genome_downsampler_tpu_torch.solvers.sequential_mcmf import (
    capped_target,
    lp_select,
)
from genome_downsampler_tpu_torch.testing.fixtures import small_example_batch
from genome_downsampler_tpu_torch.testing.reads_gen import rand_reads_uniform

N = 600  # the genome of tests/test_device_mcmf.py's random cases


def _lp_case(seed):
    """tests/test_device_mcmf.py::test_device_ssp_matches_lp_random's input."""
    rng = np.random.default_rng(seed)
    r = int(rng.integers(8, 300))
    start = rng.integers(0, N, r)
    length = rng.integers(1, N // 4, r)
    end = np.minimum(start + length, N - 1)
    cost = rng.integers(1, 60, r)
    return start, end, cost, N, int(rng.integers(1, 9))


def _quality_cost(batch):
    q = np.asarray(batch.quality, np.int64)
    return q.max() - q + 1


def _case(name):
    """(start, end, cost, n, m) of a named input."""
    if name.startswith("lp"):
        return _lp_case(int(name[2:]))
    if name == "small_example":
        b = small_example_batch()
        return (np.asarray(b.start, np.int64), np.asarray(b.end, np.int64),
                _quality_cost(b), b.ref_genome_length, 4)
    if name == "count_for_quality":  # tests/test_device_mcmf.py:62-71
        return np.array([0, 0, 5]), np.array([9, 4, 9]), np.array([50, 1, 1]), 10, 1
    if name == "config1_cut":  # config-1's depth (150 bp pairs, M=100) on 1,500 bases
        b = rand_reads_uniform(np.random.default_rng(12345), 1254, 1500, 150)
        return (np.asarray(b.start, np.int64), np.asarray(b.end, np.int64),
                _quality_cost(b), 1500, 100)
    raise ValueError(name)


CASES = [f"lp{s}" for s in range(6)] + ["small_example", "count_for_quality",
                                        "config1_cut"]


def _network(start, end, cost, n, m):
    bs, be, off, pool, _, first = jax_mcmf.build_convex_buckets(start, end, cost)
    B = bs.shape[0]
    caps = np.diff(off)
    excess = jax_mcmf._node_excess(bs, be, caps, n, m)
    lo, hi = jax_mcmf._run_tables(pool, first)
    arrays = [bs, be + 1, off[:B], caps, pool, lo, hi, excess]
    return [np.ascontiguousarray(a, np.int32) for a in arrays], int(excess[excess > 0].sum())


@pytest.mark.parametrize("seed", range(4))
def test_host_copies_equal_jax(seed):
    rng = np.random.default_rng(seed)
    r = 400
    start = rng.integers(0, 2000, r)
    end = start + rng.integers(0, 300, r)
    cost = rng.integers(0, 900, r)
    wide = cost.copy()
    wide[seed] = 1 << 12  # breaks the packed key: the lexsort path
    for c in (cost, wide):
        ours = device_mcmf.build_convex_buckets(start, end, c)
        ref = jax_mcmf.build_convex_buckets(start, end, c)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
        bs, be, off, pool, _, first = ours
        for a, b in zip(device_mcmf._run_tables(pool, first),
                        jax_mcmf._run_tables(pool, first)):
            np.testing.assert_array_equal(a, b)
        for m in (1, 7, 1000):
            np.testing.assert_array_equal(
                device_mcmf._node_excess(bs, be, np.diff(off), 2400, m),
                jax_mcmf._node_excess(bs, be, np.diff(off), 2400, m),
            )
    assert (device_mcmf.INF, device_mcmf.IMAX, device_mcmf.PI_GUARD) == (
        int(jax_mcmf.INF), int(jax_mcmf.IMAX), int(jax_mcmf.PI_GUARD))
    assert [device_mcmf.OK, device_mcmf.INFEASIBLE, device_mcmf.FIXPOINT_CAP,
            device_mcmf.PATH_OVERFLOW, device_mcmf.PI_OVERFLOW,
            device_mcmf.DEGENERATE] == [jax_mcmf.OK, jax_mcmf.INFEASIBLE,
                                        jax_mcmf.FIXPOINT_CAP, jax_mcmf.PATH_OVERFLOW,
                                        jax_mcmf.PI_OVERFLOW, jax_mcmf.DEGENERATE]


def test_small_example_fixture_is_the_jax_fixture():
    a, b = small_example_batch(), jax_small_example_batch()
    for f in ("start", "end", "quality"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("name", CASES)
def test_ssp_plain_equals_jax_solve_loop(name):
    arrays, supply0 = _network(*_case(name))
    B, n = arrays[0].shape[0], arrays[-1].shape[0] - 1
    jflow, jsupply, jstatus, jphases = jax_mcmf._phase()(
        *(jnp.asarray(a) for a in arrays[:7]), jnp.zeros(B, jnp.int32),
        jnp.zeros(n, jnp.int32), jnp.zeros(n + 1, jnp.int32),
        jnp.asarray(arrays[7]), np.int32(supply0 + 16),
    )
    n0 = ssp.ssp_solve.launches
    flow, supply, status, phases, rounds = ssp.ssp_solve(
        *(torch.from_numpy(a) for a in arrays), supply0 + 16)
    assert ssp.ssp_solve.launches == n0  # CPU tensors: the twin, no launch
    np.testing.assert_array_equal(flow.numpy(), np.asarray(jflow))
    assert (supply, status, phases) == (int(jsupply), int(jstatus), int(jphases))
    assert status == ssp.OK and phases >= 1 and rounds >= phases


@pytest.mark.parametrize("name", CASES)
def test_cpu_solver_is_exact_against_lp_and_host_mcmf(name):
    start, end, cost, n, m = _case(name)
    sel = device_mcmf.ssp_device_select(start, end, cost, n, m, "cpu")
    tgt = capped_target(start, end, n, m)
    cov = np.zeros(n + 1, np.int64)
    np.add.at(cov, start[sel], 1)
    np.add.at(cov, end[sel] + 1, -1)
    assert np.all(np.cumsum(cov)[:n] >= tgt), "coverage below min(cov_in, M)"
    lp = lp_select(start, end, n, tgt, cost)
    host = mcmf_select_convex(start, end, cost, n, m)
    assert cost[sel].sum() == cost[lp].sum() == cost[host].sum()
    np.testing.assert_array_equal(
        sel, jax_mcmf.ssp_device_select(start, end, cost, n, m))
    if name == "count_for_quality":
        assert sorted(sel.tolist()) == [1, 2]


def _batch(start, end, cost, n):
    r = len(start)
    quality = (100 - cost).astype(np.int64)  # the solver's cost: a shift of it
    return ReadBatch(
        bam_id=np.arange(r), start=start, end=end, quality=quality,
        seq_length=end - start + 1, is_first=np.tile([True, False], r // 2 + 1)[:r],
        ref_genome_length=n,
    )


def test_solver_runs_the_device_path_and_reports_it():
    start, end, cost, n, m = _case("config1_cut")
    solver = device_mcmf.QmcpDeviceMcmfSolver("cpu")
    assert solver.uses_quality_of_reads
    batch = _batch(start, end, cost, n)
    cost = _quality_cost(batch)
    sel = solver.solve(m, batch)
    stats = solver.last_stats
    assert stats["engine"] == "device"
    assert stats["phases"] >= 1 and stats["rounds"] >= stats["phases"]
    assert stats["buckets"] >= 1 and set(stats["phases_s"]) == {"buckets", "ssp", "select"}
    host = mcmf_select_convex(start, end, cost, n, m)
    assert cost[sel].sum() == cost[host].sum()


def test_long_genome_dispatches_to_host_engine(monkeypatch):
    start, end, cost, n, m = _case("lp3")
    monkeypatch.setattr(device_mcmf, "ssp_solve", lambda *a: pytest.fail("device ran"))
    monkeypatch.setattr(device_mcmf, "DEVICE_GENOME_LIMIT", n - 1)
    solver = device_mcmf.QmcpDeviceMcmfSolver("cpu")
    batch = _batch(start, end, cost, n)
    cost = _quality_cost(batch)
    sel = solver.solve(m, batch)
    assert solver.last_stats["engine"] == "host"
    np.testing.assert_array_equal(sel, mcmf_select_convex(start, end, cost, n, m))


def test_a_device_status_raises_and_is_not_answered_by_the_host(monkeypatch):
    start, end, cost, n, m = _case("lp1")

    def stopped(*args, **kw):
        return torch.zeros(args[0].shape[0], dtype=torch.int32), 3, ssp.FIXPOINT_CAP, 2, 9

    monkeypatch.setattr(device_mcmf, "ssp_solve", stopped)
    monkeypatch.setattr(device_mcmf, "mcmf_select_convex",
                        lambda *a: pytest.fail("host engine ran"))
    solver = device_mcmf.QmcpDeviceMcmfSolver("cpu")
    with pytest.raises(device_mcmf.SspStatusError, match="fixpoint") as e:
        solver.solve(m, _batch(start, end, cost, n))
    assert e.value.status == ssp.FIXPOINT_CAP and isinstance(e.value, RuntimeError)
    assert solver.last_stats["engine"] == "device"
    assert (solver.last_stats["phases"], solver.last_stats["rounds"]) == (2, 9)
    with pytest.raises(device_mcmf.SspStatusError, match="fixpoint"):
        device_mcmf.ssp_device_select(start, end, cost, n, m, "cpu")


def test_a_kernel_error_is_not_caught(monkeypatch):
    start, end, cost, n, m = _case("lp2")

    def failed(*args, **kw):
        raise RuntimeError("gd_ssp_solve: CUDA error 700 (an illegal memory access)")

    monkeypatch.setattr(device_mcmf, "ssp_solve", failed)
    solver = device_mcmf.QmcpDeviceMcmfSolver("cpu")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        solver.solve(m, _batch(start, end, cost, n))
    assert solver.last_stats["engine"] == "device"


def test_registry_builds_qmcp_cuda_and_needs_a_card(monkeypatch):
    reg = default_registry()
    assert reg.contains("qmcp-cuda") and reg.uses_quality_of_reads("qmcp-cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reg.get("qmcp-cuda")
    monkeypatch.setattr(
        "genome_downsampler_tpu_torch.device.require_cuda", lambda: torch.device("cuda"))
    inner = reg.get("qmcp-cuda").inner
    assert type(inner) is device_mcmf.QmcpDeviceMcmfSolver
    assert inner.device.type == "cuda"
    assert device_mcmf.DEVICE_GENOME_LIMIT == 131_072


def test_ssp_wrapper_checks_its_arguments():
    arrays, supply0 = _network(*_case("lp0"))
    t = [torch.from_numpy(a) for a in arrays]
    with pytest.raises(ValueError, match="no SSP solve"):
        ssp.ssp_solve(*(x.to("meta") for x in t), supply0 + 16)
    with pytest.raises(ValueError, match="excess: expected int32"):
        ssp.ssp_solve(*t[:7], t[7].long(), supply0 + 16)
    with pytest.raises(ValueError, match="pool: expected int32"):
        ssp.ssp_solve(*t[:4], t[4].long(), *t[5:], supply0 + 16)


@pytest.mark.parametrize("fn", ["ssp_device_flows", "ssp_device_select"])
def test_ssp_entry_points_need_a_named_device(monkeypatch, fn):
    """Neither entry point runs on the CPU unless asked: ``device`` has no
    default, so a call without one raises before any solve, and ``"cuda"``
    raises without a card."""
    assert (inspect.signature(getattr(device_mcmf, fn)).parameters["device"].default
            is inspect.Parameter.empty)
    start, end, cost, n, m = _case("lp0")
    solves = []
    monkeypatch.setattr(device_mcmf, "ssp_solve", lambda *a: solves.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if fn == "ssp_device_flows":
        bs, be, off, pool, _, first = device_mcmf.build_convex_buckets(start, end, cost)
        args = (bs, be, off, pool, first, n, m)
    else:
        args = (start, end, cost, n, m)
    with pytest.raises(TypeError, match="device"):
        getattr(device_mcmf, fn)(*args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(device_mcmf, fn)(*args, "cuda")
    assert not solves


def test_empty_and_zero_supply_inputs_select_nothing():
    e = np.zeros(0, np.int64)
    assert device_mcmf.ssp_device_select(e, e, e, 100, 5, "cpu").size == 0
    # M = 0: no demand, so no launch and nothing selected
    start, end, cost, n, _ = _case("lp0")
    stats = {}
    assert device_mcmf.ssp_device_select(start, end, cost, n, 0, "cpu", stats).size == 0
    assert stats["phases"] == 0
