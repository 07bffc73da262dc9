"""The blocked sweep's ablation (``ops.ablate``) against the JAX package's
``scripts/bench_kernel_ablate.py``: its Pallas ``make_kernel`` built with
``run_mode``'s grid spec and ``interpret=True``, in all seven modes, also
at blocks the CUDA kernel cuts in two chunks; the packer it uses; the port's
``bench_kernel_ablate`` entry point; the CUDA kernel's frame and refusals,
and ``chip_smoke.py --against``'s keying of the ablation's sources.

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


# (seed, W, n, B, L) of the deep cases: about 3 reads starting per
# position, spans 1..L-1; at B = 192 and 256 the CUDA kernel cuts each
# block in two chunks of up to 128 positions
DEEP = {"deep": (11, 4, 1000, B_, L_), "deep-B192": (13, 4, 1000, 192, 64),
        "deep-B256": (14, 4, 2000, 256, 256)}


@functools.cache
def _case(name):
    """(start, end, n, W, B, L, packed, target) of a named case, M = 5."""
    if name in DEEP:
        seed, W, n, B, L = DEEP[name]
        rng = np.random.default_rng(seed)
        start = np.sort(rng.integers(0, n - L, 3 * n))
        end = start + rng.integers(0, L - 1, 3 * n)
        # reads of span 1 where each window starts: taken into slot 0 at
        # once, so noroll emits them and its cur drifts
        one = np.repeat(np.arange(W) * (-(-n // (W * B)) * B), 2)
        start, end = np.concatenate([start, one]), np.concatenate([end, one])
    else:  # spans 1..L-1, then some codes moved to span L
        rng = np.random.default_rng(12)
        W, n, r, B, L = 2, 512, 500, B_, L_
        start = rng.integers(0, n - L, r)
        end = start + rng.integers(1, L, r) - 1
    packed, _, win, n_pad, _ = _native.pack_blocked(start, end, n, W, B, L,
                                                    cap_multiple=CHUNK)
    packed = np.array(packed)
    target = _native.capped_target(start, end, n_pad, 5).reshape(W, win)
    if name == "spanL":
        sel = (packed >= 0) & (np.arange(packed.size).reshape(packed.shape) % 5 == 0)
        packed[sel] = (packed[sel] // L) * L + L - 1
        assert sel.sum() > 10
    return start, end, n, W, B, L, packed, target


@pytest.mark.parametrize("mode", ablate.MODES)
@pytest.mark.parametrize("case", ["deep", "spanL", "deep-B192", "deep-B256"])
def test_twin_matches_pallas_make_kernel(case, mode):
    _, _, _, W, B, L, packed, target = _case(case)
    ref = _jax_ablate(mode, packed, target, W, B, L, CHUNK)
    n0 = ablate.blocked_ablate.launches
    got = ablate.blocked_ablate(torch.from_numpy(packed), torch.from_numpy(target),
                                W, B, L, mode)
    assert ablate.blocked_ablate.launches == n0  # CPU tensors: the twin
    out, availf, selendf = (x.numpy() for x in got)
    np.testing.assert_array_equal(availf, ref[1])
    np.testing.assert_array_equal(selendf, ref[2])
    if mode in ablate.EMITTING:
        np.testing.assert_array_equal(out, ref[0])
    else:  # the JAX kernel leaves out undefined; the port writes zeros
        assert not out.any()
    if mode == "noroll" and case != "spanL":
        # selend[0] is emitted in block 0, so cur has drifted from
        # sum(selend) when block 1 re-syncs it (and, at B > 128, where the
        # kernel's second chunk of block 0 starts, it must not)
        assert out[:, :B].any() and packed.shape[0] >= 2
    if mode == "addonly":
        assert availf.any()


def test_full_equals_kernel_a_over_window_rows():
    start, end, _, W, _, _, packed, target = _case("deep")
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
    start, end, n, W, _, _, _, _ = _case("deep")
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
    assert "match=True" in lines[-1] and "match_b=True" in lines[-1]
    assert r["full"]["out"].any()
    # full beside kernel B's twin, in turns, and the pieces of the step
    assert r["match_b"] is True and r["counts"].shape == (4, 2)
    assert [len(v) for v in r["turns"].values()] == [2, 2]
    assert r["kernel_b"]["ms"] == min(r["turns"]["kernel_b"])
    ns = {m: r[m]["ns_per_step"] for m in ablate.MODES}
    assert r["pieces_ns"] == pytest.approx({
        "take": ns["full"] - ns["notake"], "shift": ns["full"] - ns["noroll"],
        "emit": ns["full"] - ns["noemit"], "fold": ns["addonly"] - ns["emptyloop"],
        "handover": ns["emptyloop"] - ns["tileonly"]})


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
    # that is neither CPU nor CUDA: no silent twin. The tile's bound is its
    # uint16 counts of reads starting at one position, counted on the data,
    # so that refusal is shown on the kernel's side of the wrapper
    pm, tm = p.to("meta"), t.to("meta")
    with pytest.raises(ValueError, match="max_span in"):
        fn(pm, tm, 2, 128, 48, "full")
    with pytest.raises(ValueError, match="tile"):
        ablate._launch(torch.full((1, 2, 65_536), 5, dtype=torch.int32),
                       torch.zeros((2, 128), dtype=torch.int32), 2, 128, 64, "full")
    with pytest.raises(ValueError, match="no ablation kernel"):
        fn(pm, tm, 2, 128, 64, "full")
    # blocks the old (B, L) int32 tile could not hold reach the device check
    with pytest.raises(ValueError, match="no ablation kernel"):
        fn(pm, torch.zeros((2, 2048), dtype=torch.int32, device="meta"), 2, 1024,
           256, "full")


@pytest.mark.parametrize("L", ablate._CUDA_SPANS)
def test_kernel_frame_fits_shared_memory(L):
    # kernel B's frame: chunks of at most 128 positions cut within a block,
    # two uint16 (P, L) tiles and two chunks of targets and counts
    for B in range(2, 257, 2):
        P = ablate.chunk_positions(B)
        assert P == min(B, 128) and -(-B // P) <= 2
        assert ablate.shared_bytes(B, L) == 4 * P * L + 16 * P <= 227 * 1024
    assert ablate.shared_bytes(128, 256) == 133_120


@pytest.mark.parametrize("what", ["65,536 starts", "65,535 starts", "L=48"])
def test_kernel_side_refusals_name_the_bound_and_never_reach_the_twin(
        monkeypatch, what):
    def twin(*a):
        raise AssertionError("the kernel's side of the wrapper ran the twin")

    monkeypatch.setattr(ablate, "blocked_ablate_plain", twin)
    hot, L = (65_535, 64) if what == "65,535 starts" else (65_536, 64)
    if what == "L=48":
        hot, L = 16, 48
    # one group of 65,536 slots: hot reads of span 5 starting at position 3
    packed = torch.full((1, 2, 65_536), -1, dtype=torch.int32)
    packed[0, 1, :hot] = 3 * L + 4
    t = torch.zeros((2, 128), dtype=torch.int32)
    match = {"65,536 starts": "at most 65535 reads of a window starting at one "
                              "position .*; got 65536",
             "L=48": r"max_span in \(32, 64, 128, 256\); got max_span=48",
             # within the bound: the count passes, the CPU has no kernel
             "65,535 starts": "no ablation kernel for device cpu"}[what]
    n0 = ablate.blocked_ablate.launches
    with pytest.raises(ValueError, match=match):
        ablate._launch(packed, t, 2, 128, L, "full")
    assert ablate.blocked_ablate.launches == n0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("_chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the C entry of the ablation's first CUDA source, as it declared it
FIRST_ABLATE_SOURCE = '''
template <int SS, int MODE>
__global__ void __launch_bounds__(kThreads) blocked_ablate_kernel(
    const int32_t* __restrict__ packed, const int32_t* __restrict__ target,
    int32_t* __restrict__ out, int32_t* __restrict__ availf,
    int32_t* __restrict__ selendf, int64_t nbw, int64_t W, int64_t cap, int B) {
}

extern "C" int gd_blocked_ablate(const void* packed, const void* target,
                                 void* out, void* availf, void* selendf,
                                 int64_t nbw, int64_t W, int64_t cap,
                                 int64_t B, int64_t L, int64_t mode,
                                 void* stream) {
  return 0;
}
'''


@pytest.mark.parametrize("source", ["port", "first"])
def test_against_takes_the_ablation(tmp_path, source):
    cs = _chip_smoke()
    path = tmp_path / "other.cu"
    path.write_text(FIRST_ABLATE_SOURCE if source == "first" else (
        ROOT / "genome_downsampler_tpu_torch" / "ops" / "csrc" / "blocked_ablate.cu"
    ).read_text())
    assert cs.against_entry(path) == "gd_blocked_ablate"
    assert cs.AGAINST_KERNELS["gd_blocked_ablate"][0] == "blocked_ablate.cu"
    assert cs.against_entries("gd_blocked_ablate") == ("gd_blocked_ablate",)
    # both bind through the port's signature of the entry
    from genome_downsampler_tpu_torch.ops import build

    assert (cs.against_signature(path, "gd_blocked_ablate")
            == build._SIGNATURES["gd_blocked_ablate"])


def test_ptxas_lines_name_the_ablation():
    cs = _chip_smoke()
    txt = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_121blocked_ablate_kernelILi8ELi0EEEvPKiS2_PiS3_S3_lllii' "
           "for 'sm_90a'\n"
           "ptxas info    : Function properties for _ZN12_GLOBAL__N_121blocked_ablate_"
           "kernelILi8ELi0EEEvPKiS2_PiS3_S3_lllii\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 40 registers, 420 bytes cmem[0]\n")
    assert cs.PTXAS_ENTRY.findall(txt) == [("blocked_ablate", "8", "0", "0", "0", "40")]


def test_sass_loops_counts_each_loop_of_a_dump():
    from genome_downsampler_tpu_torch.scripts import sass_loops

    dump = """
		Function : _ZN12_GLOBAL__N_121blocked_ablate_kernelILi8ELi0EEEv
        /*0000*/                   MOV R1, c[0x0][0x28] ;                 /* 0x000 */
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x1, 0x80 ;    /* 0x000 */
        /*0020*/                   LDS.128 R4, [R2] ;                     /* 0x000 */
        /*0030*/                   BRA.DIV UR4, 0x90 ;                    /* 0x000 */
        /*0040*/                   SHFL.DOWN PT, R5, R4, 0x1, 0x1f ;      /* 0x000 */
        /*0050*/                   SHFL.IDX PT, R6, R4, RZ, 0x1f ;        /* 0x000 */
        /*0060*/                   STS [R3], R6 ;                         /* 0x000 */
        /*0070*/              @!P1 BRA 0x20 ;                             /* 0x000 */
        /*0080*/              @!P2 BRA 0x10 ;                             /* 0x000 */
        /*0090*/                   EXIT ;                                 /* 0x000 */
		Function : other_kernel
        /*0000*/                   EXIT ;                                 /* 0x000 */
"""
    fns = sass_loops.functions(dump)
    assert list(fns) == ["_ZN12_GLOBAL__N_121blocked_ablate_kernelILi8ELi0EEEv",
                         "other_kernel"]
    assert len(fns["other_kernel"]) == 1
    inner, outer = sass_loops.loops(fns[next(iter(fns))])
    assert inner == (0x20, 0x70, {"instructions": 6, "SHFL": 2, "LDS": 1, "STS": 1,
                                  "BAR": 0})
    assert outer == (0x10, 0x80, {"instructions": 8, "SHFL": 2, "LDS": 1, "STS": 1,
                                  "BAR": 1})
