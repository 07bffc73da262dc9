"""AddressSanitizer exercise of the port's host library (``io/csrc/*.cpp``).

    bash genome_downsampler_tpu_torch/scripts/run_asan.sh

Counterpart of the JAX package's ``scripts/asan_exercise.py``. The shell
script builds an instrumented library, preloads ASan and runs this file by
path with ``GD_HOST_SO`` naming that library (``io/build.py``), so every
call below runs the instrumented code. It drives each of the symbols that
``_native`` binds (``_native._SIGNATURES``) through the port's own wrappers
on 5,000 pairs over 30 kb from seed 7: the BAM read, region read and
write in both modes, the host greedy and the MCMF entries, both packers
(each called again after the other, since they share arenas), the bit
test, the capped target, the reconstruct, and a fuzz of truncated and
bit-flipped BAMs that must be refused cleanly. It prints the sorted names
of the symbols it drove, then the OK line.

Only numpy and ctypes run here: torch is never imported, because its
wheels (like JAX's and scipy's) may abort under ASan's interceptors. That
is why this file is run by path: the ``scripts`` package imports torch.
"""

from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path

import numpy as np

from genome_downsampler_tpu_torch import _native
from genome_downsampler_tpu_torch.config import BamApiConfig
from genome_downsampler_tpu_torch.io.bam import read_bam, read_bam_region, write_bam
from genome_downsampler_tpu_torch.solvers.native_greedy import native_greedy_select
from genome_downsampler_tpu_torch.solvers.native_mcmf import (
    mcmf_select,
    mcmf_select_bucketed,
    mcmf_select_convex,
)
from genome_downsampler_tpu_torch.testing.bam_writer import write_test_bam
from genome_downsampler_tpu_torch.testing.coverage_tester import _coverage, is_out_cover_valid
from genome_downsampler_tpu_torch.testing.reads_gen import rand_reads_uniform

N, M = 30_000, 8
W, B, L = 8, 256, 256


def record_symbols(lib) -> set:
    """Wrap each bound symbol of ``lib`` so that a call adds its name to
    the returned set."""
    drove = set()

    def counting(name, fn):
        def call(*args):
            drove.add(name)
            return fn(*args)
        return call

    for name in _native._SIGNATURES:
        setattr(lib, name, counting(name, getattr(lib, name)))
    return drove


def exercise_bam(path, tmp, batch, cfg):
    full, _, _ = read_bam(path, cfg)
    assert full.n_reads == batch.n_reads
    region = read_bam_region(path, cfg, 5_000, 20_000)
    assert region.batch.n_reads > 0
    write_bam(path, tmp / "o1.bam", full.bam_id[: full.n_reads // 2])
    write_bam(path, tmp / "o2.bam", region.batch.bam_id, ids_are_voffsets=True)
    return full


def exercise_solvers(batch):
    s = np.asarray(batch.start, np.int64)
    e = np.asarray(batch.end, np.int64)
    q = np.asarray(batch.quality, np.int64)
    sel = native_greedy_select(s, e, N, M)
    assert len(sel) > 0
    assert is_out_cover_valid(_coverage(batch), _coverage(batch, sel), M)
    c = q.max() - q + 1
    costs = [int(c[f(s, e, c, N, M)].sum())
             for f in (mcmf_select_convex, mcmf_select_bucketed, mcmf_select)]
    assert len(set(costs)) == 1, costs
    return sel


def exercise_packers(s, e):
    """Both packers, each again after the other: the second call of each
    must give what its first did, though the other overwrote the arenas.
    Returns the padded layout's slots (copied) and its slot count."""
    packed, counts, win, n_pad, slots = (np.array(x) if isinstance(x, np.ndarray) else x
                                         for x in _native.pack_blocked(s, e, N, W, B, L))
    flat, counts_f, win_f, n_pad_f, cap_f, slots_f = (
        np.array(x) if isinstance(x, np.ndarray) else x
        for x in _native.pack_flat_direct(s, e, N, W, B, L))
    assert (win_f, n_pad_f, cap_f) == (win, n_pad, packed.shape[2])
    np.testing.assert_array_equal(counts_f, counts)
    np.testing.assert_array_equal(slots_f, slots)
    live = np.arange(packed.shape[2]) < counts[..., None]
    np.testing.assert_array_equal(flat, packed[live].astype(np.uint16))
    again = _native.pack_blocked(s, e, N, W, B, L)
    for a, b in zip((packed, counts, slots), (again[0], again[1], again[4])):
        np.testing.assert_array_equal(a, b)
    again = _native.pack_flat_direct(s, e, N, W, B, L)
    for a, b in zip((flat, counts_f, slots_f), (again[0], again[1], again[5])):
        np.testing.assert_array_equal(a, b)
    return slots, packed.size, n_pad


def exercise_fuzz(path, tmp, cfg, ids):
    """Truncated and bit-flipped BAMs: each read either succeeds or raises
    IOError, and at least one is refused."""
    blob = path.read_bytes()
    frng = np.random.default_rng(20260820)
    fz = tmp / "fuzz.bam"
    n_rej = 0
    for cut in range(0, len(blob), max(1, len(blob) // 32)):
        fz.write_bytes(blob[:cut])
        try:
            read_bam(fz, cfg)
        except IOError:
            n_rej += 1
    offsets = list(range(0, 40)) + sorted(frng.integers(0, len(blob), 120).tolist())
    for off in offsets:
        mut = bytearray(blob)
        mut[off] ^= 0xFF
        fz.write_bytes(bytes(mut))
        try:
            read_bam(fz, cfg)
        except IOError:
            n_rej += 1
        try:
            write_bam(fz, tmp / "fo.bam", ids)
        except IOError:
            pass
    assert n_rej > 0


def main() -> None:
    so = os.environ.get("GD_HOST_SO")
    if not so:
        raise SystemExit("GD_HOST_SO names no library: run this through run_asan.sh")
    lib = _native.host_lib()
    assert lib._name == so, (lib._name, so)
    drove = record_symbols(lib)
    batch = rand_reads_uniform(np.random.default_rng(7), 5_000, N, 150)
    cfg = BamApiConfig(min_mapq=0, min_seq_length=0, hts_thread_count=4)
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        path = tmp / "in.bam"
        write_test_bam(path, batch, coordinate_sorted=True, make_index=True)
        full = exercise_bam(path, tmp, batch, cfg)
        s = np.asarray(full.start, np.int64)
        e = np.asarray(full.end, np.int64)
        sel = exercise_solvers(full)

        slots, nslots, n_pad = exercise_packers(s, e)
        bits = np.random.default_rng(0).integers(0, 256, (nslots + 7) // 8, dtype=np.uint8)
        got = _native.mask_select(bits, slots)
        np.testing.assert_array_equal(
            got, np.flatnonzero((bits[slots >> 3] >> (slots & 7)) & 1))
        target = _native.capped_target(s, e, n_pad, M)
        np.testing.assert_array_equal(target[:N], np.minimum(_coverage(full), M))
        assert not target[N:].any()
        # the greedy's per-end counts fit every end bucket, so the quota holds
        rec = _native.reconstruct(s, e, np.bincount(e[sel], minlength=N))
        np.testing.assert_array_equal(rec, np.sort(sel))

        exercise_fuzz(path, tmp, cfg, full.bam_id[:4])

    print("symbols:", " ".join(sorted(drove)), flush=True)
    missing = set(_native._SIGNATURES) - drove
    assert not missing, f"symbols not driven: {sorted(missing)}"
    assert "torch" not in sys.modules, "torch was imported under ASan"
    print("ASAN exercise: all native paths OK", flush=True)


if __name__ == "__main__":
    main()
