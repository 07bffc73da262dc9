"""The port's mesh engines (``parallel.mesh``, ``parallel.blocked_mesh``)
over ``torch.distributed``, held bit-equal (tolerance 0) to the JAX mesh
engines on the conftest's 8-device virtual mesh and to the sequential
sweep. One rank runs in-process; 2 and 4 ranks are ``python -m`` gloo
workers (``testing.mesh_worker``), each case with its own time-out."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from genome_downsampler_tpu.ops.coverage import capped_coverage as jax_capped
from genome_downsampler_tpu.ops.coverage import coverage_from_intervals as jax_cov
from genome_downsampler_tpu.ops.pallas_blocked import pack_blocked as jax_pack_blocked
from genome_downsampler_tpu.parallel.blocked_mesh import (
    make_blocked_mesh_solver as jax_make_blocked_mesh_solver,
)
from genome_downsampler_tpu.parallel.mesh import make_mesh_solver as jax_make_mesh_solver
from genome_downsampler_tpu.parallel.mesh import solve_on_mesh as jax_solve_on_mesh
from genome_downsampler_tpu.solvers.device_sweep import build_start_rows as jax_rows
from genome_downsampler_tpu.solvers.device_sweep import sweep_counts as jax_sweep_counts
from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform
from genome_downsampler_tpu_torch.entry import dryrun_multichip
from genome_downsampler_tpu_torch.ops.blocked import blocked_sweep_pass
from genome_downsampler_tpu_torch.parallel import launch
from genome_downsampler_tpu_torch.parallel.launch import RankMesh, global_window_mesh
from genome_downsampler_tpu_torch.parallel.mesh import make_mesh_solver, solve_on_mesh
from genome_downsampler_tpu_torch.parallel.sharded_io import solve_blocked_on_mesh
from genome_downsampler_tpu_torch.testing.mesh_worker import spawn_ranks

TIMEOUT = 120  # seconds a multi-rank case may take before its ranks are killed


def _global_sweep(start, end, n, m, L):
    """The JAX sequential sweep over the whole genome: the yardstick."""
    s, e = jnp.asarray(start), jnp.asarray(end)
    w = jnp.ones(start.shape[0], jnp.int32)
    rows = jax_rows(s, e - s + 1, w, n, L)
    z = jnp.zeros(L, jnp.int32)
    return np.asarray(jax_sweep_counts(rows, jax_capped(jax_cov(s, e, n, w), m), z, z, L)[0])


def _ranks(job, n_ranks, tmp_path, params, arrays=None):
    """Rank 0's result of ``job`` on ``n_ranks`` gloo workers; every rank
    must exit 0 and agree on the gathered ``sel``."""
    rcs, outs, res = spawn_ranks(job, n_ranks, tmp_path, params=params, arrays=arrays,
                                 timeout=TIMEOUT)
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {r} failed:\n{out[-3000:]}"
    for r in res[1:]:
        if "sel" in r:
            np.testing.assert_array_equal(r["sel"], res[0]["sel"])
    return res[0]


def _mesh_case():
    """tests/test_mesh.py's inputs: 4,000 pairs over 8,192 bases, M=8."""
    batch = rand_reads_uniform(np.random.default_rng(0), 4000, 8192, 60)
    return np.asarray(batch.start, np.int64), np.asarray(batch.end, np.int64), 8192, 8


@pytest.mark.parametrize("n_ranks", [1, 2, 4])
def test_solve_on_mesh_bit_equal_to_jax_mesh(n_ranks, tmp_path):
    start, end, n, m = _mesh_case()
    mesh8 = Mesh(np.array(jax.devices()[:8]), ("x",))
    ref = jax_solve_on_mesh(mesh8, start, end, n, m, max_span=64)
    np.testing.assert_array_equal(ref, _global_sweep(start, end, n, m, 64))
    if n_ranks == 1:
        stats = {}
        sel = solve_on_mesh(global_window_mesh("cpu"), start, end, n, m, 64, stats=stats)
        assert stats["rounds"] == 1 and stats["messages"] == 0
    else:
        out = _ranks("solve_on_mesh", n_ranks, tmp_path,
                     {"n": n, "m": m, "max_span": 64}, {"start": start, "end": end})
        sel = out["sel"]
        stats = json.loads(str(out["stats"]))
        assert 1 <= stats["rounds"] <= n_ranks
        # rank 0 sends one [2, 64] int32 carry a round after the first
        assert stats["wire_bytes"] >= (stats["rounds"] - 1) * 2 * 64 * 4
    np.testing.assert_array_equal(sel, ref)


@pytest.mark.parametrize("n_dev,w_local,m", [(2, 4, 5), (4, 2, 3), (8, 2, 9)])
def test_blocked_mesh_bit_equal_to_jax_blocked_mesh(n_dev, w_local, m, tmp_path):
    """tests/test_blocked_mesh.py's cases (B=L=32, n=2048); at n_dev=8 the
    port runs 4 ranks of 4 windows over the same 16 windows."""
    B, L, n = 32, 32, 2048
    W_total = n_dev * w_local
    batch = rand_reads_uniform(np.random.default_rng(n_dev * 10 + w_local), 1500, n, 24)
    start = np.asarray(batch.start, np.int64)
    end = np.asarray(batch.end, np.int64)

    packed, counts, win, n_pad = jax_pack_blocked(start, end, n, W_total, B, L,
                                                  cap_multiple=32)
    ones = jnp.ones(start.shape[0], jnp.int32)
    cov = jax_cov(jnp.asarray(start.astype(np.int32)), jnp.asarray(end.astype(np.int32)),
                  n_pad, ones)
    target = jax_capped(cov, m).reshape(W_total, win)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("x",))
    fn, packed_sh, counts_sh, target_sh = jax_make_blocked_mesh_solver(
        mesh, packed.shape[0], packed.shape[2], win, n_windows_local=w_local, block=B,
        max_span=L, chunk=32, interpret=True,
    )
    ref = np.asarray(fn(jax.device_put(jnp.asarray(packed), packed_sh),
                        jax.device_put(jnp.asarray(counts), counts_sh),
                        jax.device_put(target, target_sh))).reshape(-1)
    np.testing.assert_array_equal(ref, _global_sweep(start, end, n_pad, m, L))

    n_ranks = min(n_dev, 4)
    out = _ranks("blocked_mesh", n_ranks, tmp_path,
                 {"n": n, "m": m, "w_local": W_total // n_ranks, "block": B,
                  "max_span": L},
                 {"start": start, "end": end})
    np.testing.assert_array_equal(out["sel"], ref)
    assert 1 <= json.loads(str(out["stats"]))["rounds"] <= W_total


@pytest.mark.parametrize("w_local", [1, 3])
def test_blocked_mesh_one_rank_in_process(w_local):
    """One rank and no process group: the chain is the rank's own windows,
    no message is sent, and the result is the sequential sweep."""
    batch = rand_reads_uniform(np.random.default_rng(3), 800, 3000, 30)
    start, end = np.asarray(batch.start, np.int64), np.asarray(batch.end, np.int64)
    stats = {}
    sel = solve_blocked_on_mesh(global_window_mesh("cpu"), start, end, 3000, 4,
                                n_windows_local=w_local, block=64, max_span=32, stats=stats)
    np.testing.assert_array_equal(sel, _global_sweep(start, end, sel.shape[0], 4, 32))
    assert 1 <= stats["rounds"] <= w_local and stats["messages"] == 0


@pytest.mark.parametrize("n_ranks", [1, 2])
def test_dryrun_multichip(n_ranks, tmp_path):
    if n_ranks == 1:
        out = dryrun_multichip("cpu")
    else:
        out = _ranks("dryrun", n_ranks, tmp_path, {})
    assert int(out["ranks"]) == n_ranks and int(out["max_span"]) == 16
    assert 1 <= int(out["dense_rounds"]) <= n_ranks
    assert 1 <= int(out["blocked_rounds"]) <= 2 * n_ranks


def test_third_carry_stays_zero_with_targets():
    """The mesh passes targets, so kernel B's untaken ring (avail0i) is
    never read: any seed gives the same sweep as zeros."""
    rng = np.random.default_rng(5)
    W, B, L, n = 2, 32, 32, 512
    batch = rand_reads_uniform(rng, 300, n, 24)
    start, end = np.asarray(batch.start, np.int64), np.asarray(batch.end, np.int64)
    packed, counts, win, n_pad = jax_pack_blocked(start, end, n, W, B, L, cap_multiple=32)
    tgt = np.asarray(jax_capped(jax_cov(jnp.asarray(start), jnp.asarray(end), n_pad), 3))
    p, c = torch.from_numpy(np.array(packed)), torch.from_numpy(np.array(counts))
    t = torch.from_numpy(tgt.reshape(W, win).copy())
    seeds = [torch.from_numpy(rng.integers(0, 4, (W, L)).astype(np.int32)) for _ in range(3)]
    base = blocked_sweep_pass(p, c, t, seeds[0], seeds[1], W, B, L)
    other = blocked_sweep_pass(p, c, t, seeds[0], seeds[1], W, B, L, avail0i=seeds[2])
    for x, y in zip(base[:3], other[:3]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("size,n,max_span", [(3, 100, 16), (4, 64, 32)])
def test_mesh_solver_errors_match_jax(size, n, max_span):
    mesh = RankMesh(torch.device("cpu"))
    mesh.size = size
    with pytest.raises(ValueError) as ours:
        make_mesh_solver(mesh, n, max_span)
    with pytest.raises(ValueError) as ref:
        jax_make_mesh_solver(Mesh(np.array(jax.devices()[:size]), ("x",)), n, max_span)
    assert str(ours.value) == str(ref.value)


def test_backend_rule_and_one_rank_group(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert launch.default_backend("cpu", 4) == "gloo"
    assert launch.default_backend("cuda", 1) == "nccl"
    assert launch.default_backend("cuda", 2) == "gloo"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert launch._local_ranks(1) == 2
    assert launch.initialize_distributed(num_processes=1, process_id=0, device="cpu")
    try:
        assert not launch.initialize_distributed(device="cpu")  # already up
        mesh = global_window_mesh("cpu")
        assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
        # one rank: the left neighbour is the genome start
        x = torch.arange(4, dtype=torch.int32)
        assert torch.equal(mesh.shift_right(x), torch.zeros(4, dtype=torch.int32))
        assert mesh.any(torch.tensor(True)) and not mesh.any(torch.tensor(False))
        assert mesh.counters["messages"] == 2 and mesh.counters["host_syncs"] == 0
    finally:
        torch.distributed.destroy_process_group()


def test_cuda_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        global_window_mesh("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.initialize_distributed(num_processes=1, device="cuda")
