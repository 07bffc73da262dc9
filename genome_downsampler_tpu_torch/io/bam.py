"""Python binding for the native BAM reader/writer (ctypes over bamio.cpp).

The facade mirrors ``bam_api::BamApi`` (``reference/libs/bam-api/
include/bam-api/bam_api.hpp:21-88``): lazy load on first access, pair-level
filters applied during the read, GRADE quality remap after it, writer by
re-streaming the input file over sorted BAM line ids.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from genome_downsampler_tpu_torch._native import GdReadResult, host_lib
from genome_downsampler_tpu_torch.config import AmpliconBehaviour, BamApiConfig
from genome_downsampler_tpu_torch.core.readbatch import ReadBatch
from genome_downsampler_tpu_torch.io.bed_tsv import load_amplicons
from genome_downsampler_tpu_torch.utils.logging import get_logger
from genome_downsampler_tpu_torch.utils.timer import timed

_log = get_logger("io.bam")


def _to_numpy(ptr, n, dtype):
    if n == 0:
        return np.zeros(0, dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def _unpack_read_result(res, config, mode, defer_grade=False):
    """Convert a populated GdReadResult into (batch, filtered_out,
    in_single), applying the GRADE quality remap
    (``apply_amplicon_inclusion_grading``, ``bam_api.cpp:334-347``) unless
    ``defer_grade`` (sharded callers remap with GLOBAL min/max instead).
    Caller still owns/frees ``res``."""
    n = res.n_reads
    batch = ReadBatch(
        bam_id=_to_numpy(res.bam_id, n, np.int64),
        start=_to_numpy(res.start, n, np.int32),
        end=_to_numpy(res.end, n, np.int32),
        quality=_to_numpy(res.quality, n, np.int32),
        seq_length=_to_numpy(res.seq_length, n, np.int32),
        is_first=_to_numpy(res.is_first, n, np.uint8).astype(bool),
        ref_genome_length=res.ref_genome_length,
        contig=_to_numpy(res.contig, n, np.int32),
        contig_lengths=_to_numpy(res.contig_lengths, res.n_contigs, np.int64),
    )
    filtered_out = _to_numpy(res.filtered_out, res.n_filtered_out, np.int64)
    in_single = _to_numpy(res.in_single_amplicon, n, np.uint8).astype(bool)
    if (
        not defer_grade
        and config.amplicon_behaviour == AmpliconBehaviour.GRADE
        and mode == 2
        and res.max_mapq_seen > 0
        and res.min_mapq_seen < 2**31
    ):
        lo, hi = int(res.min_mapq_seen), int(res.max_mapq_seen)
        batch.quality = (
            batch.quality - lo + np.where(in_single, hi - lo, 0)
        ).astype(np.int32)
    return batch, filtered_out, in_single


def read_bam(
    path: Path | str, config: BamApiConfig
) -> Tuple[ReadBatch, np.ndarray, np.ndarray]:
    """Load, pair, and filter a BAM file.

    Returns ``(batch, filtered_out_bam_ids, in_single_amplicon)``. Under
    GRADE the batch's qualities are already remapped like
    ``apply_amplicon_inclusion_grading`` (``bam_api.cpp:334-347``):
    ``q <- q - min_mapq + (in_single_amplicon ? max_mapq - min_mapq : 0)``.
    """
    lib = host_lib()
    amps = load_amplicons(config.bed_path, config.tsv_path) if config.bed_path else []
    amp_start = np.array([a.start for a in amps], np.int64)
    amp_end = np.array([a.end for a in amps], np.int64)
    mode = config.amplicon_behaviour.value if amps else 0

    res = GdReadResult()
    with timed("read_bam"):
        rc = lib.gd_read_bam(
            str(path).encode(), config.hts_thread_count, config.min_mapq,
            config.min_seq_length, mode,
            amp_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            amp_end.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(amps), ctypes.byref(res),
        )
    if rc != 0:
        raise IOError(f"read_bam({path}): {res.error.decode()}")
    try:
        batch, filtered_out, in_single = _unpack_read_result(res, config, mode)
        _log.debug(
            "BamApi: %d records read, %d imported, %d filtered out",
            res.total_records, batch.n_reads, len(filtered_out),
        )
    finally:
        lib.gd_free_read_result(ctypes.byref(res))
    return batch, filtered_out, in_single


class RegionRead:
    """Result of :func:`read_bam_region`.

    Iterable/indexable as the historical ``(batch, filtered_out,
    in_single)`` triple; the extra fields carry what a sharded caller
    needs for safety: ``unmatched`` is an ``(m, 3)`` int64 array of
    ``(start, end, mate_pos)`` for reads whose mapped same-contig mate lay
    outside the scanned region (a too-small halo drops these pairs
    silently in the reference semantics — callers must check overlap with
    their owned window), and ``min/max_mapq_seen`` are the region-local
    GRADE statistics for a global allreduce."""

    def __init__(self, batch, filtered_out, in_single, unmatched,
                 min_mapq_seen, max_mapq_seen):
        self.batch = batch
        self.filtered_out = filtered_out
        self.in_single = in_single
        self.unmatched = unmatched
        self.min_mapq_seen = min_mapq_seen
        self.max_mapq_seen = max_mapq_seen

    def __iter__(self):
        return iter((self.batch, self.filtered_out, self.in_single))

    def __getitem__(self, i):
        return (self.batch, self.filtered_out, self.in_single)[i]


def read_bam_region(
    path: Path | str,
    config: BamApiConfig,
    lo: int,
    hi: int,
    bai_path: Path | str | None = None,
    ref_id: int = 0,
    defer_grade: bool = False,
) -> RegionRead:
    """Indexed region read for host-sharded input (coordinate-sorted BAM).

    Loads, pairs, and filters only the records with ``lo <= pos <= hi``,
    seeking via the BAM index (``<path>.bai`` by default; streamed from the
    first record when absent). Record ids in the returned batch are BGZF
    *virtual offsets*, the namespace :func:`write_bam` consumes with
    ``ids_are_voffsets=True`` — a multi-host job merges its hosts' selected
    voffsets by sort and re-streams once. Pairs whose mates both fall in
    [lo, hi] are kept; callers shard with a halo wider than the maximum
    mate distance, own reads by start position, and MUST check
    ``result.unmatched`` against their owned window (see
    ``parallel.sharded_io``).

    ``defer_grade=True`` skips the GRADE quality remap (which would use
    region-LOCAL min/max MAPQ and diverge across ranks); the caller
    allreduces ``min/max_mapq_seen`` and applies the remap globally.
    """
    lib = host_lib()
    bai = Path(bai_path) if bai_path else Path(str(path) + ".bai")
    voffset_hint = 0
    if bai.exists():
        from genome_downsampler_tpu_torch.io.bai import parse_bai, seek_voffset_for

        linear = parse_bai(bai)
        if len(linear) > ref_id:
            voffset_hint = seek_voffset_for(linear[ref_id], int(lo))

    amps = load_amplicons(config.bed_path, config.tsv_path) if config.bed_path else []
    amp_start = np.array([a.start for a in amps], np.int64)
    amp_end = np.array([a.end for a in amps], np.int64)
    mode = config.amplicon_behaviour.value if amps else 0

    res = GdReadResult()
    with timed("read_bam_region"):
        rc = lib.gd_read_bam_region(
            str(path).encode(), config.hts_thread_count, config.min_mapq,
            config.min_seq_length, mode,
            amp_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            amp_end.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(amps), voffset_hint, int(lo), int(hi), int(ref_id),
            ctypes.byref(res),
        )
    if rc != 0:
        raise IOError(f"read_bam_region({path}): {res.error.decode()}")
    try:
        batch, filtered_out, in_single = _unpack_read_result(
            res, config, mode, defer_grade=defer_grade
        )
        nu = res.n_unmatched
        unmatched = np.stack(
            [
                _to_numpy(res.unmatched_start, nu, np.int64),
                _to_numpy(res.unmatched_end, nu, np.int64),
                _to_numpy(res.unmatched_mate_pos, nu, np.int64),
            ],
            axis=1,
        ) if nu else np.zeros((0, 3), np.int64)
        min_mapq, max_mapq = int(res.min_mapq_seen), int(res.max_mapq_seen)
        _log.debug(
            "BamApi(region %d-%d): %d records scanned, %d imported, "
            "%d boundary-unmatched",
            lo, hi, res.total_records, batch.n_reads, nu,
        )
    finally:
        lib.gd_free_read_result(ctypes.byref(res))
    return RegionRead(batch, filtered_out, in_single, unmatched,
                      min_mapq, max_mapq)


def write_bam(
    in_path: Path | str, out_path: Path | str, bam_ids: np.ndarray,
    threads: int = 2, ids_are_voffsets: bool = False,
) -> int:
    """Re-stream ``in_path`` into ``out_path`` keeping the records whose line
    ids are in ``bam_ids`` (order/header preserved; ids are sorted first like
    ``BamApi::write_bam``, ``bam_api.cpp:577``). Returns records written."""
    lib = host_lib()
    ids = np.sort(np.asarray(bam_ids, np.int64))
    err = ctypes.create_string_buffer(256)
    fn = lib.gd_write_bam_voffsets if ids_are_voffsets else lib.gd_write_bam
    with timed("write_bam"):
        wrote = fn(
            str(in_path).encode(), str(out_path).encode(), threads,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(ids), err,
        )
    if wrote < 0:
        raise IOError(f"write_bam({out_path}): {err.value.decode()}")
    expected = int(np.unique(ids).shape[0])
    if int(wrote) != expected:
        raise IOError(
            f"write_bam({out_path}): wrote {int(wrote)} records but "
            f"{expected} distinct ids were requested"
        )
    return int(wrote)


class BamReader:
    """Lazy facade bundling config + input path (the ``BamApi`` role).

    ``get_batch()`` loads on first call; ``write_paired_reads`` maps read
    indices to BAM line ids and re-streams; ``write_filtered_out_reads``
    dumps the preprocessing rejects (the reference's ``-p`` flag,
    ``bam_api.cpp:526-532``).
    """

    def __init__(self, path: Path | str, config: Optional[BamApiConfig] = None):
        self.path = Path(path)
        self.config = config or BamApiConfig()
        self._batch: Optional[ReadBatch] = None
        self._filtered_out: Optional[np.ndarray] = None
        self._in_single: Optional[np.ndarray] = None

    def get_batch(self) -> ReadBatch:
        if self._batch is None:
            self._batch, self._filtered_out, self._in_single = read_bam(
                self.path, self.config
            )
        return self._batch

    @property
    def filtered_out(self) -> np.ndarray:
        self.get_batch()
        return self._filtered_out

    def write_paired_reads(self, out_path: Path | str, read_indices) -> int:
        batch = self.get_batch()
        ids = batch.bam_id[np.asarray(read_indices, np.int64)]
        return write_bam(self.path, out_path, ids, self.config.hts_thread_count)

    def write_filtered_out_reads(self, out_path: Path | str) -> int:
        return write_bam(
            self.path, out_path, self.filtered_out, self.config.hts_thread_count
        )
