"""The run's two refusals: no card where the cell needs one, and JAX (or
the JAX package) loaded in the process that prints the result."""

from __future__ import annotations

import sys

# compared with each loaded module's top-level name (before the first dot)
# whole: the port's name begins with the JAX package's
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "genome_downsampler_tpu"})


def forbidden_modules(names=None) -> list:
    """The loaded modules (or ``names``) whose top-level name is forbidden."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def card_problem(chips: int) -> str | None:
    """Why this machine cannot run a cell on ``chips`` cards, or None."""
    import torch

    if not torch.cuda.is_available():
        return f"no CUDA device (torch {torch.__version__}, CUDA {torch.version.cuda})"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} cards; {torch.cuda.device_count()} present"
    return None
