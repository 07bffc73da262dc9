"""The port's own host layer (its copies of the JAX package's host modules
and of the C++ host library) against the JAX package's, on the CPU: the
packers and host helpers byte for byte, the host solvers by selection, the
BAM writer and readers by record, the CLI by read name."""

import gzip
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from genome_downsampler_tpu.cli.main import main as jax_main
from genome_downsampler_tpu.config import BamApiConfig as JaxBamApiConfig
from genome_downsampler_tpu.io.bam import read_bam as jax_read_bam
from genome_downsampler_tpu.io.build import build_bamio as jax_build_bamio
from genome_downsampler_tpu.ops import pallas_blocked as jax_blocked
from genome_downsampler_tpu.solvers import device_sweep as jax_ds
from genome_downsampler_tpu.solvers.blocked_sweep import _capped_target_host
from genome_downsampler_tpu.solvers.registry import default_registry as jax_registry
from genome_downsampler_tpu.testing.reads_gen import rand_reads_uniform as jax_uniform
from genome_downsampler_tpu_torch import _native
from genome_downsampler_tpu_torch.config import BamApiConfig
from genome_downsampler_tpu_torch.io.bam import read_bam
from genome_downsampler_tpu_torch.io.build import build_bamio
from genome_downsampler_tpu_torch.solvers.native_greedy import native_greedy_select
from genome_downsampler_tpu_torch.solvers.registry import default_registry
from genome_downsampler_tpu_torch.testing.bam_writer import write_test_bam_fast
from genome_downsampler_tpu_torch.testing.reads_gen import rand_reads_uniform

ROOT = Path(__file__).resolve().parents[1]
SEEDS = (11, 12, 13)
FIELDS = ("bam_id", "start", "end", "quality", "seq_length", "is_first")


def _batch(seed, pairs=6000, n=200_000, read_len=150):
    return rand_reads_uniform(np.random.default_rng(seed), pairs, n, read_len)


def test_host_library_is_the_ports_own_build():
    so = build_bamio()
    assert so.parent == ROOT / "build" / "gd_host" and so.exists()
    assert so.resolve() != jax_build_bamio().resolve()
    assert (ROOT / "genome_downsampler_tpu_torch/io/csrc/greedy.cpp").exists()


@pytest.mark.parametrize("seed", SEEDS)
def test_reads_gen_equals_jax(seed):
    ours = _batch(seed)
    ref = jax_uniform(np.random.default_rng(seed), 6000, 200_000, 150)
    assert ours.ref_genome_length == ref.ref_genome_length
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))


@pytest.mark.parametrize("seed", SEEDS)
def test_packers_and_capped_target_equal_jax(seed):
    b = _batch(seed)
    W, B, L, n = 8, 128, 256, b.ref_genome_length
    # both libraries pack into arenas of their own: copy before the next call
    ours = [np.array(x) if isinstance(x, np.ndarray) else x
            for x in _native.pack_flat_direct(b.start, b.end, n, W, B, L,
                                              cap_multiple=128, cap_floor=256)]
    ref = [np.array(x) if isinstance(x, np.ndarray) else x
           for x in jax_blocked.pack_flat_direct(b.start, b.end, n, W, B, L,
                                                 cap_multiple=128, cap_floor=256)]
    for a, r in zip(ours, ref):
        np.testing.assert_array_equal(a, r)
    ours = [np.array(x) for x in _native.pack_blocked(b.start, b.end, n, W, B, L,
                                                      cap_multiple=64)]
    ref = [np.array(x) for x in jax_blocked.pack_blocked(
        b.start, b.end, n, W, B, L, cap_multiple=64, return_slots=True)]
    for a, r in zip(ours, ref):
        assert a.tobytes() == r.tobytes()
    n_pad = int(ours[3])
    assert (_native.capped_target(b.start, b.end, n_pad, 7).tobytes()
            == _capped_target_host(b.start, b.end, n_pad, 7).tobytes())


@pytest.mark.parametrize("seed", SEEDS)
def test_mask_select_and_reconstruct_equal_jax(seed):
    rng = np.random.default_rng(seed)
    slots = rng.permutation(50_000)[:20_000].astype(np.int64)
    bits = rng.integers(0, 256, 50_000 // 8, dtype=np.uint8)
    assert (_native.mask_select(bits, slots).tobytes()
            == jax_blocked.mask_select(bits, slots).tobytes())
    b = _batch(seed)
    host = native_greedy_select(b.start, b.end, b.ref_genome_length, 9)
    spe = np.bincount(b.end[host], minlength=b.ref_genome_length)
    ours = _native.reconstruct(b.start, b.end, spe)
    assert ours.tobytes() == jax_ds._reconstruct_native(b.start, b.end, spe).tobytes()
    np.testing.assert_array_equal(ours, jax_ds.reconstruct_selection(b.start, b.end, spe))
    np.testing.assert_array_equal(ours, np.sort(host))


@pytest.mark.parametrize(
    "name", ["mcp-cpu", "quasi-mcp-cpu", "mcp-cpu-py", "qmcp-cpu", "qmcp-lp-cpu", "test"]
)
def test_host_solvers_equal_jax_registry(name):
    seed = 21
    ours = rand_reads_uniform(np.random.default_rng(seed), 400, 4000, 100)
    ref = jax_uniform(np.random.default_rng(seed), 400, 4000, 100)
    reg, jreg = default_registry(), jax_registry()
    assert reg.uses_quality_of_reads(name) == jreg.uses_quality_of_reads(name)
    for m in (3, 12):
        sel = reg.get(name).solve(m, ours)
        np.testing.assert_array_equal(sel, jreg.get(name).solve(m, ref))
        # the JAX package's ReadBatch goes through the port's solvers too
        np.testing.assert_array_equal(reg.get(name).solve(m, ref), sel)


def test_bam_written_by_the_port_reads_back_equal_through_both_readers(tmp_path):
    b = _batch(31, pairs=2000, n=20_000)
    path = tmp_path / "in.bam"
    write_test_bam_fast(path, b)
    ours, _, _ = read_bam(path, BamApiConfig(min_seq_length=0, min_mapq=0))
    ref, _, _ = jax_read_bam(path, JaxBamApiConfig(min_seq_length=0, min_mapq=0))
    assert ours.n_reads == ref.n_reads == b.n_reads
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
    np.testing.assert_array_equal(np.sort(ours.start), np.sort(b.start))


def test_fast_writer_names_each_mate(tmp_path):
    """Each read of a pair carries its mate's contig (0) and start: a
    region read that holds one mate of a pair (its start in the region)
    reports the other's start (a pair of one read, the odd read out, names
    none)."""
    from genome_downsampler_tpu_torch.io.bam import read_bam_region

    b = _batch(33, pairs=1500, n=20_000, read_len=100).select(np.arange(2999))
    path = tmp_path / "in.bam"
    write_test_bam_fast(path, b)
    lo, hi = 5_000, 9_000
    region = read_bam_region(path, BamApiConfig(min_seq_length=0, min_mapq=0), lo, hi)
    us, ue, ump = region.unmatched.T
    mate = np.arange(b.n_reads) ^ 1
    inside = (b.start >= lo) & (b.start <= hi)
    want = np.flatnonzero(inside & (mate < b.n_reads))
    want = want[~inside[mate[want]]]
    assert len(want) > 100
    got = sorted(zip(us.tolist(), ue.tolist(), ump.tolist()))
    assert got == sorted(zip(b.start[want].tolist(), b.end[want].tolist(),
                             b.start[mate[want]].tolist()))


def _read_names(path):
    """The read names of a BAM file's records, in file order."""
    data = gzip.decompress(path.read_bytes())
    assert data[:4] == b"BAM\x01"
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 8 + l_name
    names = []
    while off < len(data):
        (size,) = struct.unpack_from("<i", data, off)
        l_name = data[off + 12]
        names.append(data[off + 36:off + 36 + l_name - 1].decode())
        off += 4 + size
    return names


def test_cli_mcp_cpu_writes_the_jax_clis_read_names(tmp_path):
    src = tmp_path / "in.bam"
    write_test_bam_fast(src, _batch(41, pairs=3000, n=12_000, read_len=100))
    ref, out = tmp_path / "jax.bam", tmp_path / "torch.bam"
    flags = ["-a", "mcp-cpu", "-l", "0", "-q", "0"]
    assert jax_main([str(src), "15", "-o", str(ref), *flags]) == 0
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run(
        [sys.executable, "-m", "genome_downsampler_tpu_torch", str(src), "15",
         "-o", str(out), *flags],
        cwd=ROOT, env=env, check=True, timeout=300,
    )
    names = _read_names(out)
    assert names == _read_names(ref) and 0 < len(names) < 6000
    assert out.read_bytes() == ref.read_bytes()
