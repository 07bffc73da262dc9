"""Minimal pure-Python BAM writer for test inputs.

The framework's native reader needs real BAM files to chew on and the image
has no pysam/htslib, so tests synthesize files directly: BGZF members via raw
zlib deflate + the BC extra subfield, records per the SAM spec section 4.2.
Only the fields the downsampler consumes are populated meaningfully.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from genome_downsampler_tpu_torch.core.readbatch import ReadBatch

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _bgzf_compress(data: bytes, level: int = 6) -> bytes:
    out = bytearray()
    for off in range(0, len(data), 0xFF00):
        chunk = data[off : off + 0xFF00]
        comp = zlib.compressobj(level, zlib.DEFLATED, -15)
        cdata = comp.compress(chunk) + comp.flush()
        bsize = 18 + len(cdata) + 8
        out += struct.pack(
            "<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6, ord("B"),
            ord("C"), 2, bsize - 1,
        )
        out += cdata
        out += struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF, len(chunk))
    return bytes(out)


class _BgzfTrackingWriter:
    """BGZF writer that reports the virtual offset of each write — what the
    BAI builder needs (voffset = compressed file offset << 16 | offset into
    the uncompressed block)."""

    def __init__(self):
        self.out = bytearray()
        self.pend = bytearray()

    def voffset(self) -> int:
        return (len(self.out) << 16) | len(self.pend)

    def write(self, data: bytes) -> int:
        vo = self.voffset()
        view = memoryview(data)
        while view:
            take = min(len(view), 0xFF00 - len(self.pend))
            self.pend += view[:take]
            view = view[take:]
            if len(self.pend) == 0xFF00:
                self.flush_block()
        return vo

    def flush_block(self):
        if not self.pend:
            return
        self.out += _bgzf_compress(bytes(self.pend))
        self.pend.clear()

    def finish(self) -> bytes:
        self.flush_block()
        return bytes(self.out) + _BGZF_EOF


_CIGAR_OPS = "MIDNSHP=X"


def write_test_bam_fast(
    path: Path | str,
    batch: ReadBatch,
    ref_name: str = "ref1",
) -> None:
    """Vectorized single-contig BAM writer for LARGE synthetic inputs.

    Same record content as :func:`write_test_bam` with fixed-width qnames
    (``p%09d``), coordinate-sorted, single ``<span>M`` cigar — but the
    record stream is assembled with numpy byte surgery instead of a Python
    loop, so config-4-scale inputs (10M+ reads, ~GB BAMs) synthesize in
    tens of seconds instead of many minutes. Each read of a pair (two reads
    of one ``bam_id // 2``) names its mate: ``next_refID`` 0 and
    ``next_pos`` the mate's start, which a region read needs to report a
    mate outside its region; any other read gets -1 in both.
    """
    r = batch.n_reads
    if r == 0 or len(batch.contig_lengths) > 1:
        raise ValueError("fast writer: non-empty single-contig batches only")
    order = np.argsort(batch.start, kind="stable")
    start = batch.start[order].astype(np.int64)
    end = batch.end[order].astype(np.int64)
    quality = batch.quality[order].astype(np.int64)
    seq_len = batch.seq_length[order].astype(np.int64)
    is_first = batch.is_first[order]
    pair_idx = (batch.bam_id[order] // 2).astype(np.int64)
    # each read's mate: the other read of its pair id, if there is exactly one
    by_pair = np.argsort(batch.bam_id // 2, kind="stable")
    pid = (batch.bam_id // 2)[by_pair]
    eq = pid[1:] == pid[:-1]
    pairs = np.flatnonzero(eq & ~np.r_[False, eq[:-1]] & ~np.r_[eq[1:], False])
    mate = np.full(r, -1, np.int64)
    mate[by_pair[pairs]] = by_pair[pairs + 1]
    mate[by_pair[pairs + 1]] = by_pair[pairs]
    mate = mate[order]
    has_mate = mate >= 0
    mate_ref = np.where(has_mate, 0, -1)
    mate_start = np.where(has_mate, batch.start[np.maximum(mate, 0)], -1).astype(np.int64)

    text = f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{ref_name}\tLN:{batch.ref_genome_length}\n"
    hdr = b"BAM\x01"
    hdr += struct.pack("<i", len(text)) + text.encode()
    hdr += struct.pack("<i", 1)
    nm = ref_name.encode() + b"\x00"
    hdr += struct.pack("<i", len(nm)) + nm + struct.pack(
        "<i", int(batch.ref_genome_length)
    )

    QW = 11  # "p%09d\0"
    span = end - start + 1
    seqb = (seq_len + 1) // 2
    rec_len = 32 + QW + 4 + seqb + seq_len  # fixed fields + qname+cigar+seq+qual
    tot_len = rec_len + 4  # incl. block_size prefix
    if not (seq_len == seq_len[0]).all():
        raise ValueError("fast writer: uniform seq_length only")
    n_bytes = int(tot_len[0]) * r
    buf = np.zeros((r, int(tot_len[0])), np.uint8)

    def put_i32(col, values):
        buf[:, col : col + 4] = (
            values.astype(np.uint32)[:, None]
            >> np.array([0, 8, 16, 24], np.uint32)
        ).astype(np.uint8) & 0xFF

    put_i32(0, np.full(r, rec_len[0], np.int64))   # block_size
    put_i32(4, np.zeros(r, np.int64))              # refID
    put_i32(8, start)                              # pos
    buf[:, 12] = QW                                # l_read_name
    buf[:, 13] = quality & 0xFF                    # mapq
    # bin (2 bytes) zero
    buf[:, 16] = 1                                 # n_cigar lo
    flag = 0x1 | np.where(is_first, 0x40, 0x80)
    buf[:, 18] = flag & 0xFF
    buf[:, 19] = flag >> 8
    put_i32(20, seq_len)                           # l_seq
    put_i32(24, mate_ref)                          # next_refID
    put_i32(28, mate_start)                        # next_pos
    # tlen (4 bytes at 32? no: layout is 32 fixed) — fixed part is 36 incl
    # block_size: offsets above already account for the 4-byte prefix
    qs = 36
    # qname "p%09d\0": digits vectorized
    digits = np.empty((r, 9), np.uint8)
    v = pair_idx.copy()
    for d in range(8, -1, -1):
        digits[:, d] = (v % 10) + ord("0")
        v //= 10
    buf[:, qs] = ord("p")
    buf[:, qs + 1 : qs + 10] = digits
    # qname NUL at qs+10 already zero
    cig = qs + QW
    put_i32(cig, (span << 4) | 0)                  # <span>M
    sq = cig + 4
    buf[:, sq : sq + int(seqb[0])] = 0x11          # poly-A
    buf[:, sq + int(seqb[0]) :] = 30               # qual
    raw = buf.reshape(-1).tobytes()

    # tlen field: the layout above uses 32 fixed bytes after the prefix
    # (refID..next_pos is 28 bytes; tlen occupies 32..36) — zeros, already
    del buf
    with open(path, "wb") as f:
        f.write(_bgzf_compress(hdr))
        step = 0xFF00 * 64
        for off in range(0, n_bytes, step):
            # level 1: synthetic test data, write speed over ratio
            f.write(_bgzf_compress(raw[off : off + step], level=1))
        f.write(_BGZF_EOF)


def write_indexed_test_bam_fast(path: Path | str, batch: ReadBatch) -> None:
    """Write ``batch`` with :func:`write_test_bam_fast` and index it
    (``write_bai`` over the records' voffsets, read back from the file),
    for region reads and ``--sharded`` runs."""
    from genome_downsampler_tpu_torch.config import BamApiConfig
    from genome_downsampler_tpu_torch.io.bai import write_bai
    from genome_downsampler_tpu_torch.io.bam import read_bam_region

    write_test_bam_fast(path, batch)
    region = read_bam_region(path, BamApiConfig(min_mapq=0, min_seq_length=0), 0,
                             batch.ref_genome_length)
    got = region.batch
    if got.n_reads != batch.n_reads:
        raise AssertionError(f"{Path(path).name}: read back {got.n_reads} of {batch.n_reads}")
    order = np.argsort(got.bam_id)
    write_bai(str(path) + ".bai", got.start[order], got.end[order], got.bam_id[order])


def write_test_bam(
    path: Path | str,
    batch: ReadBatch,
    ref_name: str = "ref1",
    coordinate_sorted: bool = False,
    extra_refs: list[tuple[str, int]] | None = None,
    cigars: list[list[tuple[int, str]]] | None = None,
    make_index: bool = False,
) -> None:
    """Write ``batch`` as a BAM file.

    Each read becomes one record: qname ``p<pair_index>`` (mates share it),
    flag ``PAIRED | READ1/READ2``, a single ``<span>M`` cigar op (or the
    explicit per-read ``cigars`` — lists of (length, op) with ops from
    ``MIDNSHP=X``), and a poly-A sequence of ``seq_length`` bases.
    ``coordinate_sorted`` reorders records by position (bam line ids then
    differ from batch order, which is what real position-sorted inputs look
    like). ``make_index`` (requires ``coordinate_sorted``) also writes a
    ``<path>.bai`` linear index for region reads.
    """
    if make_index and not coordinate_sorted:
        raise ValueError("make_index requires coordinate_sorted=True")
    multi = len(batch.contig_lengths) > 1 or (
        batch.n_reads and int(batch.contig.max()) > 0
    )
    if multi:
        # reads carry per-read contig ids; build the ref table from the
        # batch's contig_lengths
        if make_index:
            raise ValueError("make_index supports single-contig batches only")
        refs = [
            (f"{ref_name[:-1]}{i + 1}" if ref_name[-1:].isdigit() else
             f"{ref_name}_{i + 1}", int(ln))
            for i, ln in enumerate(batch.contig_lengths)
        ]
    else:
        refs = [(ref_name, batch.ref_genome_length)] + list(extra_refs or [])
    text = "@HD\tVN:1.6\n" + "".join(
        f"@SQ\tSN:{nm}\tLN:{ln}\n" for nm, ln in refs
    )

    hdr = b"BAM\x01"
    hdr += struct.pack("<i", len(text)) + text.encode()
    hdr += struct.pack("<i", len(refs))
    for name, ln in refs:
        nm = name.encode() + b"\x00"
        hdr += struct.pack("<i", len(nm)) + nm + struct.pack("<i", int(ln))

    order = np.arange(batch.n_reads)
    if coordinate_sorted:
        order = np.lexsort((batch.start, batch.contig))

    w = _BgzfTrackingWriter()
    w.write(hdr)
    rec_voffs, rec_starts, rec_ends = [], [], []
    for i in order:
        pair_idx = int(batch.bam_id[i]) // 2
        qname = f"p{pair_idx}".encode() + b"\x00"
        span = int(batch.end[i]) - int(batch.start[i]) + 1
        l_seq = int(batch.seq_length[i])
        flag = 0x1 | (0x40 if batch.is_first[i] else 0x80)
        if cigars is not None:
            ops = cigars[int(i)]
            cigar = b"".join(
                struct.pack("<I", (ln << 4) | _CIGAR_OPS.index(op))
                for ln, op in ops
            )
            n_cigar = len(ops)
        else:
            cigar = struct.pack("<I", (span << 4) | 0)  # <span>M
            n_cigar = 1
        seq = bytes([0x11] * ((l_seq + 1) // 2))  # poly-A nibbles
        qual = bytes([30] * l_seq)
        rec = struct.pack(
            "<iiBBHHHiiii",
            int(batch.contig[i]),    # refID
            int(batch.start[i]),     # pos
            len(qname),              # l_read_name
            int(batch.quality[i]) & 0xFF,  # mapq
            0,                       # bin
            n_cigar,                 # n_cigar_op
            flag,
            l_seq,
            0,                       # next_refID
            int(batch.start[i ^ 1]) if batch.n_reads > (i ^ 1) else -1,
            0,                       # tlen
        )
        rec += qname + cigar + seq + qual
        vo = w.write(struct.pack("<i", len(rec)) + rec)
        rec_voffs.append(vo)
        rec_starts.append(int(batch.start[i]))
        rec_ends.append(int(batch.end[i]))

    with open(path, "wb") as f:
        f.write(w.finish())
    if make_index:
        from genome_downsampler_tpu_torch.io.bai import write_bai

        write_bai(
            str(path) + ".bai",
            np.array(rec_starts, np.int64),
            np.array(rec_ends, np.int64),
            np.array(rec_voffs, np.uint64),
        )
