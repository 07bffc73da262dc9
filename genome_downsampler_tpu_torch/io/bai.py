"""BAM index (BAI) support: parse the standard format, build linear-index
files, and map genome windows to BGZF virtual-offset seek points.

This powers host-sharded input (SURVEY.md section 5.7/7, BASELINE config 5):
each host of a multi-process job looks up its genome window in the index
and reads only that region of the BAM via ``gd_read_bam_region`` instead of
streaming the whole file. The reference has no index support at all — it
always streams the entire input (``bam_api.cpp:359-507``).

Format (SAM spec section 5.2): magic ``BAI\\1``; per reference a list of
bins (each with chunk voffset pairs) and a *linear index* — for every 16 kb
tiling window of the reference, the smallest virtual offset of an alignment
overlapping it. Only the linear index is used for region seeks here; files
written by :func:`write_bai` carry ``n_bin = 0`` (documented deviation: the
reader streams from the linear-index seek point rather than running binned
chunk queries, so bins are unnecessary — standard BAIs from samtools parse
fine, their bins are simply ignored).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

LINEAR_SHIFT = 14  # 16 kb tiling windows, per the SAM spec


def parse_bai(path: Path | str) -> list[np.ndarray]:
    """Parse a BAI file; returns the linear index (uint64 voffsets) per
    reference sequence. Bins are skipped."""
    data = Path(path).read_bytes()
    if data[:4] != b"BAI\x01":
        raise IOError(f"{path}: not a BAI file")
    off = 4
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    linear = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        for _ in range(n_bin):
            _bin, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8 + 16 * n_chunk
        (n_intv,) = struct.unpack_from("<i", data, off)
        off += 4
        ioff = np.frombuffer(data, np.uint64, n_intv, off).copy()
        off += 8 * n_intv
        linear.append(ioff)
    return linear


def write_bai(
    path: Path | str,
    starts: np.ndarray,
    ends: np.ndarray,
    voffsets: np.ndarray,
    n_ref: int = 1,
) -> None:
    """Write a linear-index-only BAI for coordinate-sorted records of
    reference 0. ``voffsets[i]`` is the BGZF virtual offset of record i."""
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    voffsets = np.asarray(voffsets, np.uint64)
    if starts.size and np.any(np.diff(starts) < 0):
        raise ValueError("records must be coordinate-sorted to index")

    if starts.size:
        n_intv = int(ends.max() >> LINEAR_SHIFT) + 1
        nohit = np.uint64(np.iinfo(np.uint64).max)
        ioff = np.full(n_intv, nohit, np.uint64)
        w_lo = starts >> LINEAR_SHIFT
        w_hi = ends >> LINEAR_SHIFT
        # smallest voffset of an overlapping alignment per window,
        # vectorized over records one window-offset at a time (reads span
        # only a couple of 16 kb windows)
        for d in range(int((w_hi - w_lo).max()) + 1):
            mask = w_lo + d <= w_hi
            np.minimum.at(ioff, (w_lo + d)[mask], voffsets[mask])
        # fill gaps with the previous value so lookups never skip forward
        empty = ioff == nohit
        idx = np.where(~empty, np.arange(n_intv), 0)
        np.maximum.accumulate(idx, out=idx)
        ioff = ioff[idx]
        ioff[ioff == nohit] = 0  # leading windows before any record
    else:
        ioff = np.zeros(0, np.uint64)

    out = bytearray(b"BAI\x01")
    out += struct.pack("<i", n_ref)
    out += struct.pack("<i", 0)  # ref 0: n_bin = 0 (linear index only)
    out += struct.pack("<i", len(ioff))
    out += ioff.tobytes()
    for _ in range(n_ref - 1):  # further refs: empty
        out += struct.pack("<ii", 0, 0)
    Path(path).write_bytes(bytes(out))


def seek_voffset_for(linear_ref0: np.ndarray, start: int) -> int:
    """Virtual offset to seek to so that no record with pos >= ``start`` is
    missed. 0 means "no hint: stream from the first record"."""
    if linear_ref0.size == 0:
        return 0
    w = min(start >> LINEAR_SHIFT, linear_ref0.size - 1)
    return int(linear_ref0[w])
