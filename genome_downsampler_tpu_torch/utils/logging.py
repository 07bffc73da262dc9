"""Stderr logging with ERROR < INFO < DEBUG levels.

Replaces the reference's stream logger
(``reference/libs/logging/include/logging/log.hpp:7-31``). Deliberate
deviation, documented per SURVEY.md section 5.5: the reference parses a
``-v`` flag but never raises the log level (``SET_LOG_LEVEL`` has zero call
sites), so its DEBUG timings never print. Here ``-v`` actually works.
"""

from __future__ import annotations

import logging
import sys

_FMT = "[%(levelname)s] %(message)s"
_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FMT))
    root = logging.getLogger("genome_downsampler_tpu_torch")
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    root.propagate = False
    _configured = True


def get_logger(name: str = "genome_downsampler_tpu_torch") -> logging.Logger:
    _configure()
    if name != "genome_downsampler_tpu_torch" and not name.startswith("genome_downsampler_tpu_torch."):
        name = f"genome_downsampler_tpu_torch.{name}"
    return logging.getLogger(name)


def set_verbosity(verbose: bool) -> None:
    _configure()
    logging.getLogger("genome_downsampler_tpu_torch").setLevel(
        logging.DEBUG if verbose else logging.INFO
    )
