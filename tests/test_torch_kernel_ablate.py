"""The blocked sweep's ablation (``ops.ablate``) against the JAX package's
``scripts/bench_kernel_ablate.py``: its Pallas ``make_kernel`` built with
``run_mode``'s grid spec and ``interpret=True``, in all seven modes; the
packer it uses; the port's ``bench_kernel_ablate`` entry point.

Every comparison is integer bit-equality. Inputs are made from a numpy
seed and handed to both packages as numpy arrays.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from genome_downsampler_tpu_torch import _native
from genome_downsampler_tpu_torch.ops import ablate, sweep
from genome_downsampler_tpu_torch.scripts import bench_kernel_ablate

ROOT = Path(__file__).resolve().parents[1]
W_, B_, L_, CHUNK = 4, 128, 64, 128


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_script_{name}", ROOT / "scripts" / f"{name}.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


AB = _load_script("bench_kernel_ablate")


def _jax_ablate(mode, packed, target, W, B, L, chunk):
    """``make_kernel`` with ``run_mode``'s grid spec (``:141-177``), in
    interpret mode, from zero carries; returns (out, availf, selendf)."""
    nbw, _, cap = packed.shape
    win = nbw * B
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(nbw,),
        in_specs=[
            pl.BlockSpec((1, W, cap), lambda t, c: (t, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((W, B), lambda t, c: (0, t), memory_space=pltpu.VMEM),
            pl.BlockSpec((W, L), lambda t, c: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((W, L), lambda t, c: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=[
            pl.BlockSpec((W, B), lambda t, c: (0, t), memory_space=pltpu.VMEM),
            pl.BlockSpec((W, L), lambda t, c: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((W, L), lambda t, c: (0, 0), memory_space=pltpu.VMEM),
        ],
        scratch_shapes=[
            pltpu.VMEM((B, W, L), jnp.float32),
            pltpu.VMEM((W, L), jnp.int32),
            pltpu.VMEM((W, L), jnp.int32),
            pltpu.VMEM((B, W), jnp.int32),
            pltpu.VMEM((B, W), jnp.int32),
        ],
    )
    zeros = jnp.zeros((W, L), jnp.int32)
    out = pl.pallas_call(
        AB.make_kernel(B, chunk, mode),
        grid_spec=grid_spec,
        out_shape=[
            jax.ShapeDtypeStruct((W, win), jnp.int32),
            jax.ShapeDtypeStruct((W, L), jnp.int32),
            jax.ShapeDtypeStruct((W, L), jnp.int32),
        ],
        interpret=True,
    )(jnp.zeros(1, jnp.int32), jnp.asarray(packed), jnp.asarray(target), zeros, zeros)
    return [np.asarray(x) for x in out]


@functools.cache
def _case(name):
    """(start, end, n, W, packed, target) of a named case, M = 5."""
    rng = np.random.default_rng(11 if name == "deep" else 12)
    if name == "deep":  # about 3 reads starting per position, spans 1..L-1
        W, n, r = 4, 1000, 3000
        start = np.sort(rng.integers(0, n - L_, r))
        end = start + rng.integers(0, L_ - 1, r)
        # reads of span 1 where each window starts: taken into slot 0 at
        # once, so noroll emits them and its cur drifts
        one = np.repeat(np.arange(4) * 256, 2)
        start, end = np.concatenate([start, one]), np.concatenate([end, one])
    else:  # spans 1..L-1, then some codes moved to span L
        W, n, r = 2, 512, 500
        start = rng.integers(0, n - L_, r)
        end = start + rng.integers(1, L_, r) - 1
    packed, _, win, n_pad, _ = _native.pack_blocked(start, end, n, W, B_, L_,
                                                    cap_multiple=CHUNK)
    packed = np.array(packed)
    target = _native.capped_target(start, end, n_pad, 5).reshape(W, win)
    if name == "spanL":
        sel = (packed >= 0) & (np.arange(packed.size).reshape(packed.shape) % 5 == 0)
        packed[sel] = (packed[sel] // L_) * L_ + L_ - 1
        assert sel.sum() > 10
    return start, end, n, W, packed, target


@pytest.mark.parametrize("mode", ablate.MODES)
@pytest.mark.parametrize("case", ["deep", "spanL"])
def test_twin_matches_pallas_make_kernel(case, mode):
    _, _, _, W, packed, target = _case(case)
    ref = _jax_ablate(mode, packed, target, W, B_, L_, CHUNK)
    n0 = ablate.blocked_ablate.launches
    got = ablate.blocked_ablate(torch.from_numpy(packed), torch.from_numpy(target),
                                W, B_, L_, mode)
    assert ablate.blocked_ablate.launches == n0  # CPU tensors: the twin
    out, availf, selendf = (x.numpy() for x in got)
    np.testing.assert_array_equal(availf, ref[1])
    np.testing.assert_array_equal(selendf, ref[2])
    if mode in ablate.EMITTING:
        np.testing.assert_array_equal(out, ref[0])
    else:  # the JAX kernel leaves out undefined; the port writes zeros
        assert not out.any()
    if mode == "noroll" and case == "deep":
        # selend[0] is emitted in block 0, so cur has drifted from
        # sum(selend) when block 1 re-syncs it
        assert out[:, :B_].any() and packed.shape[0] >= 2
    if mode == "addonly":
        assert availf.any()


def test_full_equals_kernel_a_over_window_rows():
    start, end, _, W, packed, target = _case("deep")
    win = packed.shape[0] * B_
    rows = np.zeros((W, win, L_), np.int32)
    np.add.at(rows, (start // win, start % win, end - start), 1)
    out, _, _ = ablate.blocked_ablate(torch.from_numpy(packed),
                                      torch.from_numpy(target), W, B_, L_, "full")
    z = torch.zeros((W, L_), dtype=torch.int32)
    ref, _, _ = sweep.dense_sweep_counts(torch.from_numpy(rows),
                                         torch.from_numpy(target), z, z, L_)
    assert torch.equal(out, ref) and out.any()


@pytest.mark.parametrize("use_native", [True, False])
def test_pack_blocked_matches_the_scripts_packer(use_native):
    start, end, n, W, _, _ = _case("deep")
    ref = AB.pack_blocked(start, end, n, W, B_, L_, cap_multiple=CHUNK,
                          use_native=use_native)
    ref = [np.array(x) for x in ref]  # the native packer's arena is shared
    packed, counts, win, n_pad, _ = _native.pack_blocked(start, end, n, W, B_, L_,
                                                         cap_multiple=CHUNK)
    np.testing.assert_array_equal(packed, ref[0])
    np.testing.assert_array_equal(counts, ref[1])
    assert (win, n_pad) == (int(ref[2]), int(ref[3]))
    np.testing.assert_array_equal(
        _native.capped_target(start, end, n_pad, 30),
        AB._capped_target_host(start, end, n_pad, 30),
    )


def test_entry_point_runs_the_twins_on_cpu():
    lines = []
    res = bench_kernel_ablate.run("cpu", 0.0004, [(2, 128)], reps=1,
                                  log=lines.append)
    r = res[(2, 128)]
    assert r["match"] is True and r["win"] == 512
    assert r["packed"].shape[:2] == (4, 2) and r["target"].shape == (2, 512)
    assert [ln.split(":")[0].strip() for ln in lines[2:9]] == list(ablate.MODES)
    assert "match=True" in lines[-1]
    assert r["full"]["out"].any()


def test_entry_point_refuses_to_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_kernel_ablate.main(["0.001", "2:128"])


def test_ablate_rejects_bad_arguments():
    p = torch.full((2, 2, 128), -1, dtype=torch.int32)
    t = torch.zeros((2, 256), dtype=torch.int32)
    fn = ablate.blocked_ablate
    with pytest.raises(ValueError, match="mode"):
        fn(p, t, 2, 128, 64, "nothing")
    with pytest.raises(ValueError, match="windows"):
        fn(p, t, 4, 128, 64, "full")
    with pytest.raises(ValueError, match="even"):
        fn(p, torch.zeros((2, 254), dtype=torch.int32), 2, 127, 64, "full")
    with pytest.raises(ValueError, match="packed"):
        fn(p.long(), t, 2, 128, 64, "full")
    with pytest.raises(ValueError, match="target"):
        fn(p, t[:, :128], 2, 128, 64, "full")
    with pytest.raises(ValueError, match="contiguous"):
        fn(p, torch.zeros((256, 2), dtype=torch.int32).T, 2, 128, 64, "full")
    # a span, then a tile, the CUDA kernel does not take, then a device
    # that is neither CPU nor CUDA: no silent twin
    pm, tm = p.to("meta"), t.to("meta")
    with pytest.raises(ValueError, match="max_span in"):
        fn(pm, tm, 2, 128, 48, "full")
    with pytest.raises(ValueError, match="tile"):
        fn(pm, torch.zeros((2, 2048), dtype=torch.int32, device="meta"), 2, 1024,
           256, "full")
    with pytest.raises(ValueError, match="no ablation kernel"):
        fn(pm, tm, 2, 128, 64, "full")
