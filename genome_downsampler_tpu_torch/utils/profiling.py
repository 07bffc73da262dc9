"""Profiler hooks: ``torch.profiler`` traces and named regions.

Counterpart of the JAX package's ``utils/profiling.py``. ``trace`` records
the host's activity, and the card's whenever one is present, around any
phase and writes a Chrome trace (``trace.json``, for chrome://tracing or
Perfetto) into a directory; ``annotate`` names a region of the timeline.
The per-phase wall timers live in ``utils.timer`` and the solvers' laps.
torch is imported only when a trace or a region is asked for, so that a
host-only CLI run (``-a mcp-cpu``) does not pay its import.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Any, Iterator, Optional

from genome_downsampler_tpu_torch.utils.logging import get_logger

_log = get_logger("torch.profiling")

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[Path | str]) -> Iterator[Optional[Any]]:
    """Profile the block into ``log_dir/trace.json`` and yield the
    profiler (for ``key_averages``); a no-op yielding None when
    ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    import torch

    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _log.info("profiling to %s", path)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(path / TRACE_FILE))


def annotate(name: str, args: Optional[str] = None):
    """Named trace region (shows in the profiler timeline), with ``args``
    recorded beside the name; costs a few microseconds when no profiler
    runs."""
    import torch

    return torch.profiler.record_function(name, args)
