"""Kernel A's variants C and B (``ops.variants``) against the JAX package's
``scripts/kernel_variants.py``: its Pallas kernels run by its own
``run_variant`` (specs, rotation, grid) with ``interpret=True``, and the
JAX ``sweep_counts``; the port's ``kernel_variants`` entry point.

Every comparison is integer bit-equality. Inputs are made from a numpy
seed and handed to both packages as numpy arrays.
"""

import importlib.util
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_downsampler_tpu.ops.coverage import capped_coverage as jax_capped
from genome_downsampler_tpu.ops.coverage import coverage_from_intervals as jax_cov
from genome_downsampler_tpu.solvers import device_sweep as jax_ds
from genome_downsampler_tpu_torch.ops import variants
from genome_downsampler_tpu_torch.scripts import kernel_variants
from genome_downsampler_tpu_torch.testing import variant_cases

ROOT = Path(__file__).resolve().parents[1]


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_script_{name}", ROOT / "scripts" / f"{name}.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


KV = _load_script("kernel_variants")


@pytest.fixture
def interpret(monkeypatch):
    """Run the script's ``pl.pallas_call`` with ``interpret=True``; returns
    the list of the arguments each built call was given."""
    calls = []
    real = KV.pl.pallas_call

    def pallas_call(*a, **kw):
        fn = real(*a, interpret=True, **kw)

        def call(*args):
            calls.append(args)
            return fn(*args)

        return call

    shim = types.SimpleNamespace(
        **{k: getattr(KV.pl, k) for k in dir(KV.pl) if not k.startswith("__")}
    )
    shim.pallas_call = pallas_call
    monkeypatch.setattr(KV, "pl", shim)
    return calls


def _problem(seed, n, L, m):
    """(rows[n, L], target[n]) as numpy, built by the JAX package, from
    reads of every span 1..L."""
    rng = np.random.default_rng(seed)
    r = n // 2
    start = rng.integers(0, n - L, r)
    end = start + rng.integers(1, L + 1, r) - 1
    s, e = jnp.asarray(start), jnp.asarray(end)
    w = jnp.ones(r, jnp.int32)
    rows = jax_ds.build_start_rows(s, e - s + 1, w, n, L)
    target = jax_capped(jax_cov(s, e, n, w), m)
    return np.asarray(rows), np.asarray(target)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.mark.parametrize(
    "seed,L,block,n,m",
    [(0, 64, 256, 2048, 9), (1, 128, 512, 4096, 5), (2, 128, 256, 1024, 14),
     (3, 64, 512, 3072, 3)],
)
def test_twins_match_pallas_variants_and_scan(interpret, seed, L, block, n, m):
    rows, target = _problem(seed, n, L, m)
    assert rows[:, L - 1].any()  # reads of span L
    z = jnp.zeros(L, jnp.int32)
    ref = np.asarray(jax_ds.sweep_counts(jnp.asarray(rows), jnp.asarray(target), z, z, L)[0])
    pal_c, _ = KV.run_variant(KV.make_variant_c, jnp.asarray(rows),
                              jnp.asarray(target), L, block)
    pal_b, _ = KV.run_variant(KV.make_variant_b, jnp.asarray(rows),
                              jnp.asarray(target), L, block, rotated=True)
    rot_jax = np.asarray(interpret[-1][0])  # the script's host rotation

    n0 = (variants.sweep_variant_c.launches, variants.sweep_variant_b.launches)
    rot = variants.rotate_rows(_t(rows))
    np.testing.assert_array_equal(rot.numpy(), rot_jax)
    got_c = variants.sweep_variant_c(_t(rows), _t(target), L).numpy()
    got_b = variants.sweep_variant_b(rot, _t(target), L).numpy()
    # CPU tensors: the twins, no launch
    assert (variants.sweep_variant_c.launches, variants.sweep_variant_b.launches) == n0
    np.testing.assert_array_equal(got_c, pal_c)
    np.testing.assert_array_equal(got_b, pal_b)
    np.testing.assert_array_equal(got_c, ref)
    np.testing.assert_array_equal(got_b, ref)
    assert ref.any()


def test_rotate_rows_puts_each_read_in_its_end_slot():
    rows = _t(np.arange(5 * 32, dtype=np.int32).reshape(5, 32))
    rot = variants.rotate_rows(rows)
    for p in range(5):
        for k in range(32):
            assert rot[p, (p + k) % 32] == rows[p, k]


def test_entry_point_runs_the_twins_on_cpu():
    lines = []
    res, rows, target = kernel_variants.run("cpu", reps=1, log=lines.append,
                                            pairs=1500, genome=2000, n=2048,
                                            max_coverage=12)
    assert rows.shape == (2048, 256) and target.shape == (2048,)
    assert int(rows.sum()) == 3000  # every read of the 1500 pairs, once
    assert set(res) == {"A", "C", "B"}
    assert all(r["match"] for r in res.values())
    assert all("match=True" in x for x in lines) and len(lines) == 3
    assert res["A"]["out"].shape == (2048,) and res["A"]["out"].any()


def test_entry_point_refuses_to_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kernel_variants.main()


@pytest.mark.parametrize("fn", [variants.sweep_variant_c, variants.sweep_variant_b])
def test_variants_reject_bad_arguments(fn):
    rows = torch.zeros((16, 64), dtype=torch.int32)
    t = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="max_span"):
        fn(rows, t, 32)
    with pytest.raises(ValueError, match="rows"):
        fn(rows.long(), t, 64)
    with pytest.raises(ValueError, match="target"):
        fn(rows, t[:8], 64)
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.zeros((64, 16), dtype=torch.int32).T, t, 64)
    with pytest.raises(ValueError, match="rows"):
        fn(rows[None], t, 64)
    # a span the CUDA kernels do not take, then a device that is neither
    # CPU nor CUDA: no silent twin
    meta = torch.zeros((16, 48), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="max_span in"):
        fn(meta, t.to("meta"), 48)
    with pytest.raises(ValueError, match="no sweep variant"):
        fn(rows.to("meta"), t.to("meta"), 64)


@pytest.mark.parametrize("L", [32, 64, 128, 256])
def test_chunk_geometry_fits_the_card(L):
    # the kernels' chunks: a power of two, whole groups of L / 32 positions
    # for variant B, two row buffers within 192 KB, all within the 227 KB a
    # block may use
    p = variants.chunk_positions(L)
    assert p == {32: 512, 64: 256, 128: 128, 256: 64}[L]
    assert p % (L // 32) == 0 and 2 * p * L * 4 <= 192 * 1024
    assert variants.shared_bytes(L) == 4 * (2 * p * L + 4 * p) <= 232_448


@pytest.mark.parametrize("L", [32, 64, 128, 256])
@pytest.mark.parametrize("edge", ["1", "P-1", "P", "P+1", "2P+1", "ragged", "deep stack"])
def test_twins_match_pallas_variants_at_chunk_edges(interpret, L, edge):
    # the rows the card tests give the kernels; the Pallas variants sweep
    # each row as one block
    lengths = variant_cases.edge_lengths(L)
    if edge == "deep stack":
        n, m, stack = lengths["ragged"] + L, 1000, 3000
    else:
        n, m, stack = lengths[edge], L // 4, 0
    rows, target = variant_cases.variant_case(n, L, m, seed=L + n, stack=stack)
    pal_c, _ = KV.run_variant(KV.make_variant_c, jnp.asarray(rows),
                              jnp.asarray(target), L, n)
    pal_b, _ = KV.run_variant(KV.make_variant_b, jnp.asarray(rows),
                              jnp.asarray(target), L, n, rotated=True)
    rot = variants.rotate_rows(_t(rows))
    np.testing.assert_array_equal(
        variants.sweep_variant_c(_t(rows), _t(target), L).numpy(), pal_c)
    np.testing.assert_array_equal(variants.sweep_variant_b(rot, _t(target), L).numpy(),
                                  pal_b)
    if stack:
        assert rows[min(3, n - 1)].sum() > stack and target.max() == m
        assert pal_c.sum() >= m


def test_empty_row_gives_empty_results():
    rows = torch.zeros((0, 64), dtype=torch.int32)
    t = torch.zeros(0, dtype=torch.int32)
    for fn in (variants.sweep_variant_c, variants.sweep_variant_b):
        assert fn(rows, t, 64).shape == (0,)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("_chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the C entries of the variants' first CUDA source, as it declared them
FIRST_VARIANTS_SOURCE = '''
extern "C" int gd_sweep_variant_c(const void* rows, const void* target,
                                  void* out, int64_t n, int64_t L,
                                  void* stream) {
  return launch<false>(rows, target, out, n, L, stream);
}

extern "C" int gd_sweep_variant_b(const void* rows_rot, const void* target,
                                  void* out, int64_t n, int64_t L,
                                  void* stream) {
  return launch<true>(rows_rot, target, out, n, L, stream);
}
'''


@pytest.mark.parametrize(
    "source,key",
    [("sweep_variants.cu", "gd_sweep_variant"), ("dense_sweep.cu", "gd_dense_sweep"),
     ("blocked_sweep.cu", "gd_blocked_sweep"),
     ("blocked_sweep_wide.cu", "gd_blocked_sweep_wide"),
     ("blocked_select.cu", "gd_blocked_select"), ("ssp.cu", "gd_ssp_solve"),
     ("first variants source", "gd_sweep_variant")],
)
def test_against_takes_the_variants_as_one_kernel(tmp_path, source, key):
    cs = _chip_smoke()
    csrc = ROOT / "genome_downsampler_tpu_torch" / "ops" / "csrc"
    path = tmp_path / "other.cu"
    path.write_text(FIRST_VARIANTS_SOURCE if source == "first variants source"
                    else (csrc / source).read_text())
    assert cs.against_entry(path) == key
    assert cs.AGAINST_KERNELS[key][0] in (source, "sweep_variants.cu")
    # the variants' key binds both C entries, each with its own signature
    entries = cs.against_entries(key)
    assert entries == (("gd_sweep_variant_c", "gd_sweep_variant_b")
                       if key == "gd_sweep_variant" else (key,))


def test_against_refuses_half_of_the_variants(tmp_path):
    cs = _chip_smoke()
    path = tmp_path / "other.cu"
    path.write_text(FIRST_VARIANTS_SOURCE.split("extern", 2)[0]
                    + "extern" + FIRST_VARIANTS_SOURCE.split("extern", 2)[1])
    with pytest.raises(ValueError, match="defines none"):
        cs.against_entry(path)


def test_ptxas_lines_name_the_variants():
    cs = _chip_smoke()
    txt = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_120sweep_variant_kernelILi8ELb1EEEvPKiS2_Pil' for 'sm_90a'\n"
           "ptxas info    : Function properties for _ZN12_GLOBAL__N_120sweep_variant_"
           "kernelILi8ELb1EEEvPKiS2_Pil\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 90 registers, 380 bytes cmem[0]\n")
    assert cs.PTXAS_ENTRY.findall(txt) == [("sweep_variant", "8", "1", "0", "0", "90")]
