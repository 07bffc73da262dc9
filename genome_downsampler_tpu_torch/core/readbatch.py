"""Tensorized paired-read container (SoA of fixed-width arrays).

Design notes
------------
The reference keeps reads in AOS/SOA C++ containers
(``reference/libs/bam-api/include/bam-api/soa_paired_reads.hpp:19-24``);
the SoA layout is the right shape for XLA, so it is the *only* layout here.
Key invariants preserved from the reference:

- Pairs are stored adjacently with the first mate first
  (``reference/libs/bam-api/src/bam_api.cpp:456-461``), so the mate of
  read ``i`` is ``i ^ 1`` (see ``find_pairs``,
  ``reference/libs/bam-api/src/bam_api.cpp:239-273``).
- ``start``/``end`` are inclusive genome indices; ``end`` is derived from the
  alignment's reference span (``pos + cigar2rlen - 1``,
  ``reference/libs/bam-api/src/read.cpp:11-13``).
- ``bam_id`` is the 0-based line number of the record in the source BAM
  (``reference/libs/bam-api/include/bam-api/read.hpp:11``), which the
  writer uses to re-stream the input file.

All arrays are NumPy on host; :meth:`device_arrays` produces padded,
static-shape int32 device tensors for the solvers (XLA requires static
shapes; padded slots carry ``weight 0`` and the sentinel interval
``start=0, end=-1``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np


def _as_i64(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.int64))


def _as_i32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.int32))


@dataclasses.dataclass
class ReadBatch:
    """A batch of (paired) reads in structure-of-arrays form.

    Attributes
    ----------
    bam_id:      int64[R]  source BAM line number of each read
    start:       int32[R]  inclusive start index on the reference genome
    end:         int32[R]  inclusive end index on the reference genome
    quality:     int32[R]  MAPQ (possibly remapped by amplicon GRADE)
    seq_length:  int32[R]  query sequence length
    is_first:    bool[R]   BAM_FREAD1 flag of the record
    ref_genome_length: int reference genome length of the batch's contig
                           (for a whole multi-contig file: the first contig,
                           like ``bam_api.cpp:422``; per-contig sub-batches
                           from :meth:`split_by_contig` carry their own)
    contig:      int32[R]  contig (refID) of each read; zeros by default
    contig_lengths: int64[C] length of every contig in the source header
                           (defaults to ``[ref_genome_length]``)

    Unlike the reference — which applies its first contig's length to ALL
    records (``bam_api.cpp:422``) — multi-contig batches are solved per
    contig via :meth:`split_by_contig` (documented deviation).
    """

    bam_id: np.ndarray
    start: np.ndarray
    end: np.ndarray
    quality: np.ndarray
    seq_length: np.ndarray
    is_first: np.ndarray
    ref_genome_length: int
    contig: Optional[np.ndarray] = None
    contig_lengths: Optional[np.ndarray] = None

    def __post_init__(self):
        self.bam_id = _as_i64(self.bam_id)
        self.start = _as_i32(self.start)
        self.end = _as_i32(self.end)
        self.quality = _as_i32(self.quality)
        self.seq_length = _as_i32(self.seq_length)
        self.is_first = np.ascontiguousarray(np.asarray(self.is_first, dtype=bool))
        self.ref_genome_length = int(self.ref_genome_length)
        n = len(self.bam_id)
        if self.contig is None:
            self.contig = np.zeros(n, np.int32)
        else:
            self.contig = _as_i32(self.contig)
        if self.contig_lengths is None:
            self.contig_lengths = np.array([self.ref_genome_length], np.int64)
        else:
            self.contig_lengths = _as_i64(self.contig_lengths)
        for name in ("start", "end", "quality", "seq_length", "is_first",
                     "contig"):
            if len(getattr(self, name)) != n:
                raise ValueError(f"ReadBatch field {name} has inconsistent length")

    # ------------------------------------------------------------------
    @property
    def n_reads(self) -> int:
        return int(self.bam_id.shape[0])

    def __len__(self) -> int:
        return self.n_reads

    def mate_index(self, i: int) -> int:
        """Mate of read ``i`` under the adjacent-pair invariant."""
        return i + 1 if self.is_first[i] else i - 1

    # ------------------------------------------------------------------
    @classmethod
    def empty(cls, ref_genome_length: int = 0) -> "ReadBatch":
        z64 = np.zeros(0, np.int64)
        z32 = np.zeros(0, np.int32)
        zb = np.zeros(0, bool)
        return cls(z64, z32, z32, z32, z32, zb, ref_genome_length)

    @classmethod
    def from_reads(
        cls, reads, ref_genome_length: int
    ) -> "ReadBatch":
        """Build from an iterable of (bam_id, start, end, quality, seq_length,
        is_first) tuples — the in-memory fixture path (the reference's second
        ``BamApi`` constructor, ``bam_api.cpp:44-45``)."""
        rows = list(reads)
        if not rows:
            return cls.empty(ref_genome_length)
        cols = list(zip(*rows))
        return cls(
            np.array(cols[0], np.int64),
            np.array(cols[1], np.int32),
            np.array(cols[2], np.int32),
            np.array(cols[3], np.int32),
            np.array(cols[4], np.int32),
            np.array(cols[5], bool),
            ref_genome_length,
        )

    def select(self, indices) -> "ReadBatch":
        idx = np.asarray(indices, dtype=np.int64)
        return ReadBatch(
            self.bam_id[idx],
            self.start[idx],
            self.end[idx],
            self.quality[idx],
            self.seq_length[idx],
            self.is_first[idx],
            self.ref_genome_length,
            contig=self.contig[idx],
            contig_lengths=self.contig_lengths,
        )

    def split_by_contig(self) -> list:
        """Split a multi-contig batch into per-contig sub-batches.

        Returns ``[(ref_id, sub_batch, global_indices), ...]`` for every
        contig that has reads, in ref_id order. Each sub-batch carries the
        contig's own length as ``ref_genome_length`` so solvers see a
        consistent coordinate system; ``global_indices`` maps a sub-batch
        read index back to this batch. Pair adjacency is preserved: mates
        always share a contig (cross-contig pairs are dropped at read time,
        ``io/csrc/bamio.cpp`` pair filter) and pairs are emitted together.
        """
        out = []
        for ref in np.unique(self.contig):
            idx = np.flatnonzero(self.contig == ref)
            sub = self.select(idx)
            if int(ref) < len(self.contig_lengths):
                sub.ref_genome_length = int(self.contig_lengths[int(ref)])
            out.append((int(ref), sub, idx))
        return out

    # ------------------------------------------------------------------
    def padded(self, multiple: int = 1024) -> Tuple[dict, np.ndarray]:
        """Pad arrays to a static shape (next multiple of ``multiple``).

        Returns ``(arrays, valid_mask)`` where padded slots hold the neutral
        interval ``start=0, end=-1`` (contributes zero coverage with weight 0)
        and ``valid_mask`` marks real reads. Static shapes keep XLA from
        recompiling per input size.
        """
        r = self.n_reads
        cap = max(multiple, -(-r // multiple) * multiple)
        pad = cap - r

        def p32(a, fill=0):
            return np.concatenate([a, np.full(pad, fill, np.int32)])

        valid = np.concatenate([np.ones(r, bool), np.zeros(pad, bool)])
        arrays = dict(
            start=p32(self.start, 0),
            end=p32(self.end, -1),
            quality=p32(self.quality, 0),
            valid=valid,
        )
        return arrays, valid

    # ------------------------------------------------------------------
    def find_pairs(self, solution: np.ndarray) -> np.ndarray:
        """Extend a solution (read indices) with the mates of every selected
        read, deduplicated, preserving first-seen order.

        Vectorized re-design of ``BamApi::find_pairs``
        (``bam_api.cpp:239-273``): the reference walks the solution appending
        each id and its mate if unseen; order is (id, mate) per solution
        entry. We reproduce that exact order.
        """
        sol = np.asarray(solution, dtype=np.int64)
        mates = np.where(self.is_first[sol], sol + 1, sol - 1)
        inter = np.empty(2 * sol.size, dtype=np.int64)
        inter[0::2] = sol
        inter[1::2] = mates
        # np.unique(return_index) then sort-by-first-occurrence == reference
        # first-seen dedupe order.
        _, first_pos = np.unique(inter, return_index=True)
        return inter[np.sort(first_pos)]
