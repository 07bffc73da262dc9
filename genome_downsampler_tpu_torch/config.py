"""Configuration dataclasses.

Mirrors the reference's config tier (SURVEY.md section 5.6):
``BamApiConfig``/``Builder`` (``reference/libs/bam-api/include/bam-api/
bam_api_config.hpp:18-25``, ``bam_api_config_builder.cpp:5-29``) and the
``AmpliconBehaviour`` enum (``bam_api_config.hpp:9-16``). Defaults match
``src/app.hpp:22-25``: min length 90, min MAPQ 30, 2 I/O threads.
"""

from __future__ import annotations

import dataclasses
import enum
from pathlib import Path
from typing import Optional


class AmpliconBehaviour(enum.Enum):
    IGNORE = 0
    FILTER = 1
    GRADE = 2


@dataclasses.dataclass
class BamApiConfig:
    min_seq_length: int = 90
    min_mapq: int = 30
    hts_thread_count: int = 2
    amplicon_behaviour: AmpliconBehaviour = AmpliconBehaviour.IGNORE
    bed_path: Optional[Path] = None
    tsv_path: Optional[Path] = None
