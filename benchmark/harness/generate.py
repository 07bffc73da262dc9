"""The one general sample generator: a configuration's ``reads`` block
names a layout generator (``generators/<name>.py``, ``layout(rng, **kw) ->
(start, end)``) and its arguments; this draws each sample of a run from
``(seed, stream, index)``.

Every seed runs the same set of layouts, in another order: a sample's
layout (its reads' starts and ends, which set the solvers' work) comes from
a stream of layouts that no seed changes, and the seed orders each block of
``BLOCK`` consecutive samples' layouts among themselves, shuffles the
pairs of each sample and draws its MAPQ, uniform in ``0..max_quality`` as
the upstream reads-gen draws it. So a run's work does not move with its
seed, while no layout is handed over twice in a run and every seed gives
the program other inputs.
"""

from __future__ import annotations

import numpy as np

from harness import spec

# the three streams drawn from one run's seed
WINDOW, WARM, CHECK = 0, 1, 2
# samples whose layouts a seed orders among themselves
BLOCK = 16
# the layouts' own stream, the same for every seed
LAYOUTS = 0x6C61796F


def rng_for(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    """A generator for sample ``index`` of ``stream``; any whole ``seed``."""
    return np.random.default_rng([seed % 2**64, stream, index])


def layout_index(seed: int, stream: int, index: int) -> int:
    """Which layout sample ``index`` of ``stream`` takes: a permutation,
    drawn from the seed, of each block of ``BLOCK`` samples."""
    block, slot = divmod(index, BLOCK)
    order = np.random.default_rng([seed % 2**64, stream, block, BLOCK]).permutation(BLOCK)
    return block * BLOCK + int(order[slot])


def sample(reads: dict, seed: int, stream: int, index: int) -> dict:
    """One sample of the configuration's ``reads`` block: ``start``, ``end``
    (inclusive), ``quality`` (int64 arrays; mates at adjacent indices, first
    mate first) and ``genome_length``."""
    kw = {k: v for k, v in reads.items() if k not in ("generator", "max_quality")}
    lay = np.random.default_rng([LAYOUTS, stream, layout_index(seed, stream, index), 1])
    start, end = spec.load_generator(reads["generator"]).layout(lay, **kw)
    rng = rng_for(seed, stream, index)
    pairs = rng.permutation(len(start) // 2)
    order = np.stack([2 * pairs, 2 * pairs + 1], axis=1).ravel()
    quality = rng.integers(0, int(reads["max_quality"]) + 1, len(start))
    return {"start": start[order], "end": end[order], "quality": quality,
            "genome_length": int(reads["genome_length"])}
