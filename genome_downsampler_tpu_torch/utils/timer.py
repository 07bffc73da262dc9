"""Wall-clock timing hooks.

``ScopedTimer`` mirrors the reference RAII timer
(``reference/src/tests/scoped_timer.hpp:6-17``); ``timed`` wraps the
per-phase ``chrono`` timings the reference logs at DEBUG around solve /
read_bam / write_bam (``reference/src/app.cpp:132-139``,
``bam_api.cpp:497-506``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

from genome_downsampler_tpu_torch.utils.logging import get_logger

_log = get_logger("timer")


class ScopedTimer:
    """Context manager printing elapsed seconds at INFO on exit."""

    def __init__(self, label: str = ""):
        self.label = label
        self.elapsed = 0.0

    def __enter__(self) -> "ScopedTimer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._start
        prefix = f"{self.label}: " if self.label else ""
        _log.info("%sTook: %.6f seconds.", prefix, self.elapsed)


@contextlib.contextmanager
def timed(label: str) -> Iterator[ScopedTimer]:
    """DEBUG-level phase timer: ``<label> took <t> seconds``."""
    t = ScopedTimer.__new__(ScopedTimer)
    t.label = label
    t.elapsed = 0.0
    start = time.perf_counter()
    try:
        yield t
    finally:
        t.elapsed = time.perf_counter() - start
        _log.debug("%s took %.6f seconds", label, t.elapsed)
