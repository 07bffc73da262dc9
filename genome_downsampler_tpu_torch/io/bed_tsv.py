"""BED/TSV amplicon parsing.

Parity targets: ``BamApi::process_bed_file`` (``reference/libs/bam-api/
src/bam_api.cpp:101-152``), ``process_tsv_file`` (``:154-187``) and the
primer-pairing logic of ``set_amplicon_filter`` (``:55-95``), including the
reference's quirk of pairing *alphabetically consecutive* primers when no
TSV is given (the BED entries land in a name-sorted map, ``:74-90``).
Malformed lines are logged and skipped, like the reference.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from genome_downsampler_tpu_torch.utils.logging import get_logger

_log = get_logger("io.bed_tsv")


@dataclasses.dataclass(frozen=True)
class Amplicon:
    """Closed interval [start, end]; a read is included iff fully inside
    (``amplicon.cpp:5-7``)."""

    start: int
    end: int

    def includes(self, read_start: int, read_end: int) -> bool:
        return self.start <= read_start and read_end <= self.end


def parse_bed(path: Path | str) -> Dict[str, Tuple[int, int]]:
    """name -> (start, end) primer map (name-sorted like std::map)."""
    primers: Dict[str, Tuple[int, int]] = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            chrom = fields[0] if len(fields) > 0 else ""
            start_s = fields[1] if len(fields) > 1 else ""
            end_s = fields[2] if len(fields) > 2 else ""
            name = fields[3] if len(fields) > 3 else ""
            try:
                start, end = int(start_s), int(end_s)
            except ValueError as e:
                _log.error("Invalid argument: %s", e)
                continue
            if chrom and start_s and end_s and name:
                primers.setdefault(name, (start, end))
            else:
                _log.error("Invalid BED line: %s", line)
    _log.debug("%d primers have been read", len(primers))
    return dict(sorted(primers.items()))


def parse_tsv(path: Path | str) -> List[Tuple[str, str]]:
    pairs: List[Tuple[str, str]] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            left = fields[0] if len(fields) > 0 else ""
            right = fields[1] if len(fields) > 1 else ""
            if left and right:
                pairs.append((left, right))
            else:
                _log.error("Invalid TSV line: %s", line)
    _log.debug("%d pairs of primers have been read", len(pairs))
    return pairs


def load_amplicons(
    bed_path: Path | str, tsv_path: Optional[Path | str] = None
) -> List[Amplicon]:
    """Build amplicons from primer bounds.

    With a TSV: each (left, right) primer-name pair spans one amplicon from
    the lower primer's start to the higher's end. Without one: consecutive
    primers in name order are paired (reference quirk, ``bam_api.cpp:74-90``).
    """
    primer_map = parse_bed(bed_path)
    amplicons: List[Amplicon] = []
    if tsv_path:
        for left, right in parse_tsv(tsv_path):
            lp = primer_map.get(left, (0, 0))
            rp = primer_map.get(right, (0, 0))
            if lp[0] > rp[0]:
                lp, rp = rp, lp
            amplicons.append(Amplicon(lp[0], rp[1]))
    else:
        names = list(primer_map)
        for i in range(0, len(names) - 1, 2):
            lp = primer_map[names[i]]
            rp = primer_map[names[i + 1]]
            if lp[0] > rp[0]:
                lp, rp = rp, lp
            amplicons.append(Amplicon(lp[0], rp[1]))
    return amplicons
