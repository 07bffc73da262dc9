"""Config-5's pipeline (``genome_downsampler_tpu_torch.scripts.bench_chr1``
and ``ops.device_pack``) against the JAX package's ``scripts/bench_chr1.py``,
on the CPU.

The JAX script runs unedited, loaded by path, with its module's ``N`` and
``W`` shrunk and ``blocked_windowed_sweep`` wrapped to run its Pallas
kernel with ``interpret=True`` and record what it is given and returns.
The case (15,000 reads over 30,000 bases, W = 4, M = 30: 75x) selects
6,027 reads, fewer than it has. Every comparison is integer equality.
"""

import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from genome_downsampler_tpu.ops import pallas_blocked as jax_blocked
from genome_downsampler_tpu_torch.ops import device_pack
from genome_downsampler_tpu_torch.ops.blocked import blocked_windowed_sweep
from genome_downsampler_tpu_torch.scripts import bench_chr1

ROOT = Path(__file__).resolve().parents[1]
N, WINDOWS, READS, M = 30_000, 4, 15_000, 30
GEOMETRY = dict(block=bench_chr1.B, span=bench_chr1.L, cap=bench_chr1.CAP,
                read_len=bench_chr1.READ_LEN)


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "_jax_script_bench_chr1", ROOT / "scripts" / "bench_chr1.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _main_output(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


@pytest.fixture(scope="module")
def jax_run():
    """The JAX script's ``main()`` at the small case: the ``packed`` and
    ``target`` its kernel B was given, its ``sel`` and ``rounds``, and the
    printed fill and counts."""
    mod = _load_script()
    mod.N, mod.W = N, WINDOWS
    rec = {}
    real = jax_blocked.blocked_windowed_sweep

    def recorded(*a, **kw):
        sel, rounds = real(*a, **{**kw, "interpret": True})
        rec.update(packed=np.asarray(a[0]), target=np.asarray(a[2]),
                   sel=np.asarray(sel), rounds=int(rounds))
        return sel, rounds

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_blocked, "blocked_windowed_sweep", recorded)
        mp.setattr(sys, "argv", ["bench_chr1.py", str(READS / 1e6), str(M)])
        out = _main_output(mod.main)
    rec["fill"] = int(re.search(r"max group fill=(\d+)", out).group(1))
    rec["oracle"] = int(re.search(r"greedy: .*selected=(\d+)", out).group(1))
    rec["selected"] = int(re.search(r"rounds=\d+ selected=(\d+)", out).group(1))
    return rec


@pytest.fixture(scope="module")
def port_pack():
    packed, counts, diff, fill = device_pack.pack_reads(READS, N, WINDOWS, "cpu", **GEOMETRY)
    return packed, counts, device_pack.capped_target(diff, M, WINDOWS), fill


@pytest.mark.parametrize("n", [N, bench_chr1.N])
def test_weyl_streams_equal_the_scripts(monkeypatch, n):
    """The port's host copies and the card's int64 stream (the product
    masked to 32 bits, which wraps from the third read on) against the
    script's uint32 numpy."""
    mod = _load_script()
    monkeypatch.setattr(mod, "N", n)
    r = 300_000
    starts = bench_chr1.host_starts(r, n)
    np.testing.assert_array_equal(starts, mod.host_starts(r))
    np.testing.assert_array_equal(bench_chr1.host_quality(r), mod.host_quality(r))
    np.testing.assert_array_equal(
        device_pack.weyl_starts(r, n, bench_chr1.READ_LEN, "cpu").numpy(), starts)


def test_twin_pack_equals_the_scripts_build(jax_run, port_pack):
    packed, counts, target, fill = port_pack
    jp = jax_run["packed"]
    assert jp.shape == tuple(packed.shape) == (N // WINDOWS // 128 + 1, WINDOWS, 128)
    # each group's codes ascending, pads last
    big = np.iinfo(np.int32).max
    want = np.sort(np.where(jp < 0, big, jp), axis=-1)
    np.testing.assert_array_equal(np.where(want == big, -1, want), packed.numpy())
    np.testing.assert_array_equal((jp >= 0).sum(-1), counts.numpy())
    np.testing.assert_array_equal(jax_run["target"], target.numpy())
    assert fill == jax_run["fill"] == int(counts.max())
    assert int(counts.sum()) == READS


def test_port_solve_on_the_twin_pack_equals_the_scripts(jax_run, port_pack):
    packed, counts, target, _ = port_pack
    sel, rounds = blocked_windowed_sweep(packed, counts, target, WINDOWS, 128, 256)
    np.testing.assert_array_equal(sel.numpy(), jax_run["sel"])
    assert rounds == jax_run["rounds"] > 1
    assert int(sel.sum()) == jax_run["selected"] == jax_run["oracle"] < READS


def test_run_on_the_cpu_matches_the_oracle(jax_run):
    res = bench_chr1.run("cpu", READS, M, n=N, windows=WINDOWS, log=lambda *a: None)
    assert res["ok"] and res["valid"] and res["per_end_equal"]
    assert res["selected"] == res["oracle"] == jax_run["selected"] < READS
    assert res["first_difference"] is None
    assert res["rounds"] == jax_run["rounds"] and res["passes"] == res["rounds"] + 1
    assert res["fill"] == jax_run["fill"]
    assert set(res["laps"]) == {"host_gen", "host_greedy", "gen_pack", "target", "solve",
                                "check"}
    assert res["memory_peak_bytes"] is None and res["device"] == "cpu"


def test_run_reports_a_read_the_oracle_lacks(monkeypatch):
    """The checks have teeth: with one read taken out of the oracle, the
    count and the per-end counts differ at that read's end."""
    real = bench_chr1.native_greedy_select
    dropped = {}

    def short(s, e, n, m):
        sel = real(s, e, n, m)
        dropped["end"] = int(e[sel[7]])
        return np.delete(sel, 7)

    monkeypatch.setattr(bench_chr1, "native_greedy_select", short)
    res = bench_chr1.run("cpu", 6_000, M, n=12_000, windows=2, log=lambda *a: None)
    assert not res["ok"] and res["valid"]
    assert res["selected"] == res["oracle"] + 1
    first = res["first_difference"]
    assert first["position"] == dropped["end"] and first["sel"] == first["oracle"] + 1


def test_covers_target_finds_a_base_below_target():
    sel = torch.tensor([0, 2, 0, 0, 1, 0, 0, 0], dtype=torch.int32)
    # read_len 3: coverage at p is sel[p] + sel[p + 1] + sel[p + 2]
    cov = [2, 2, 1, 1, 1, 0, 0, 0]
    assert bench_chr1.covers_target(sel, torch.tensor(cov, dtype=torch.int32), 3)
    cov[2] = 2
    assert not bench_chr1.covers_target(sel, torch.tensor(cov, dtype=torch.int32), 3)


def test_kernels_decomposition_equals_the_twin():
    """csrc/device_pack.cu in numpy: pass 1 hands out slots in the order
    the atomics happen to run (here shuffled), pass 2 ranks each group's
    codes (smaller codes, then equal codes at lower slots); the result is
    the twin's, whatever the order."""
    r, n, w = 20_000, 50_000, 4
    packed, counts, diff, fill = device_pack.pack_reads(r, n, w, "cpu", **GEOMETRY)
    win, nbw, n_pad = device_pack.geometry(n, w, 128)
    cap = GEOMETRY["cap"]
    s = device_pack.weyl_starts(r, n, 150, "cpu").numpy()
    group = ((s % win) // 128) * w + s // win
    code = (s % 128) * 256 + 149
    for seed in range(2):
        got = np.full(nbw * w * cap, -1, np.int64)
        cnt = np.zeros(nbw * w, np.int64)
        d = np.zeros(n_pad + 1, np.int64)
        for i in np.random.default_rng(seed).permutation(r):
            slot = cnt[group[i]]
            cnt[group[i]] += 1
            if slot < cap:
                got[group[i] * cap + slot] = code[i]
            d[s[i]] += 1
            d[s[i] + 150] -= 1
        rows = got.reshape(-1, cap)
        for g in np.flatnonzero(cnt):
            v = rows[g, :min(cnt[g], cap)].copy()
            rank = [(v < x).sum() + (v[:k] == x).sum() for k, x in enumerate(v)]
            rows[g, rank] = v
        np.testing.assert_array_equal(rows.reshape(packed.shape), packed.numpy())
        np.testing.assert_array_equal(cnt.reshape(counts.shape), counts.numpy())
        np.testing.assert_array_equal(d, diff.numpy())
        assert cnt.max() == fill


def test_pack_raises_past_cap():
    with pytest.raises(ValueError, match="more than cap=8"):
        device_pack.pack_reads(READS, N, WINDOWS, "cpu", **{**GEOMETRY, "cap": 8})
    with pytest.raises(ValueError, match="read_len <= min"):
        device_pack.pack_reads(READS, N, WINDOWS, "cpu", **{**GEOMETRY, "span": 128})
    with pytest.raises(ValueError, match="no device pack"):
        device_pack.pack_reads(READS, N, WINDOWS, "meta", **GEOMETRY)


def test_qmcp_equals_the_scripts():
    mod = _load_script()
    r, m = 20_000, M
    out = _main_output(mod.main_qmcp, r, m)
    want = re.search(r"selected=(\d+) cost=(\d+)", out)
    res = bench_chr1.run_qmcp(r, m, log=lambda *a: None)
    assert (res["selected"], res["cost"]) == (int(want.group(1)), int(want.group(2)))
    assert res["valid"] and res["n"] == r * 150 // 60 and res["selected"] < r


def test_entry_point_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_chr1.main(["0.01", "30"])
    assert bench_chr1._args([]) == (100_000_000, 30)
    assert bench_chr1._args(["0.5", "20"]) == (500_000, 20)
