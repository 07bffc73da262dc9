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

A configuration at genome scale opts in to a cheaper making with
``"making": "genome_scale"`` in its ``reads`` block (``_GenomeScale``):
each stream's layout 0 is drawn once, and layout ``k`` is it moved along
the genome; the seed rotates the pairs' order and the MAPQ. The same
guarantees hold, and configurations without the key are made as before,
bit for bit.
"""

from __future__ import annotations

import functools
import json
import math

import numpy as np

from harness import spec

# the three streams drawn from one run's seed
WINDOW, WARM, CHECK = 0, 1, 2
# samples whose layouts a seed orders among themselves
BLOCK = 16
# the layouts' own stream, the same for every seed
LAYOUTS = 0x6C61796F
# the ``making`` of configurations that opt in to the genome-scale path
GENOME_SCALE = "genome_scale"
# the last entry of the seed sequence of the MAPQ drawn at genome scale
# (that of a block's order is ``BLOCK``)
QUALITY = 0x6D617071


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
    mate first) and ``genome_length``; at genome scale int32 arrays, with
    ``seq_length``, ``bam_id`` and ``is_first`` besides."""
    if reads.get("making") == GENOME_SCALE:
        return _genome_scale(json.dumps(reads, sort_keys=True), stream).sample(seed, index)
    kw = {k: v for k, v in reads.items() if k not in ("generator", "max_quality")}
    lay = np.random.default_rng([LAYOUTS, stream, layout_index(seed, stream, index), 1])
    start, end = spec.load_generator(reads["generator"]).layout(lay, **kw)
    rng = rng_for(seed, stream, index)
    pairs = rng.permutation(len(start) // 2)
    order = np.stack([2 * pairs, 2 * pairs + 1], axis=1).ravel()
    quality = rng.integers(0, int(reads["max_quality"]) + 1, len(start))
    return {"start": start[order], "end": end[order], "quality": quality,
            "genome_length": int(reads["genome_length"])}


class _GenomeScale:
    """A stream's samples at genome scale (``making: genome_scale``).

    The stream's layout 0, drawn once as on the default path, is the base.
    A pair's anchor is its leftmost base, and ``E`` the widest pair's
    extent; anchors are taken modulo ``D = genome_length - E + 1``, so no
    pair crosses the genome's end. Layout ``k`` moves every anchor by ``k *
    step`` modulo ``D`` (``step`` coprime to ``D``), so each index of a
    stream takes a layout of its own, the same for every seed, and a
    uniform layout stays uniform. The seed rotates the pairs' order and
    takes the MAPQ as a window of an array it draws once, uniform in
    ``0..max_quality``. ``bam_id``, ``is_first``, the seed's MAPQ and the
    reads' lengths are shared, read-only, by every sample of the stream.

    A pair's two starts (or spans) are kept as one int64 word, the first
    mate's in the low half: a sample's int32 ``start`` and ``end`` are
    views of int64 sums, and moving a pair adds ``shift * (2**32 + 1)``,
    less ``domain * (2**32 + 1)`` where it wraps. So a sample is four
    numpy passes over its pairs, on one core, into two new arrays."""

    def __init__(self, reads: dict, stream: int):
        kw = {k: v for k, v in reads.items()
              if k not in ("generator", "max_quality", "making")}
        lay = np.random.default_rng([LAYOUTS, stream, 0, 1])
        start, end = spec.load_generator(reads["generator"]).layout(lay, **kw)
        s2 = np.asarray(start, np.int64).reshape(-1, 2)
        e2 = np.asarray(end, np.int64).reshape(-1, 2)
        anchor = np.minimum(s2[:, 0], s2[:, 1])
        self.n = int(reads["genome_length"])
        self.domain = self.n - int((np.maximum(e2[:, 0], e2[:, 1]) - anchor).max())
        if self.domain < 1 or int(anchor.min()) < 0:
            raise ValueError("a pair of the base layout lies outside the genome")
        self.step = int(self.domain * (math.sqrt(5) - 1) / 2) or 1
        while math.gcd(self.step, self.domain) != 1:
            self.step += 1
        self.pairs = p = len(anchor)
        self.max_quality = int(reads["max_quality"])
        self.stream = stream
        lo = anchor % self.domain
        # doubled along the pairs, so that a rotation is a view
        self.anchor = _frozen(_twice(lo.astype(np.int32)))
        self.start = _frozen(_twice(_pack(s2 - (anchor - lo)[:, None])))
        self.span = _frozen(_twice(_pack(e2 - s2)))
        self.length = _frozen(_twice((e2 - s2 + 1).astype(np.int32).ravel()))
        self.bam_id = _frozen(np.arange(2 * p, dtype=np.int64))
        self.is_first = _frozen(np.tile(np.array([True, False]), p))
        self._quality: tuple = (None, None)

    def quality(self, seed: int) -> np.ndarray:
        """The seed's MAPQ, two samples long (drawn once a seed)."""
        if self._quality[0] != seed:
            rng = np.random.default_rng([seed % 2**64, self.stream, 0, QUALITY])
            q = rng.integers(0, self.max_quality + 1, 4 * self.pairs, dtype=np.int32)
            self._quality = (seed, _frozen(q))
        return self._quality[1]

    def sample(self, seed: int, index: int) -> dict:
        shift = layout_index(seed, self.stream, index) * self.step % self.domain
        rng = rng_for(seed, self.stream, index)
        r = int(rng.integers(self.pairs))
        q = int(rng.integers(2 * self.pairs))
        p = self.pairs
        both = 2**32 + 1
        wrap = self.anchor[r:r + p] >= self.domain - shift
        start = np.array([shift * both, (shift - self.domain) * both])[wrap.view(np.uint8)]
        start += self.start[r:r + p]
        end = start + self.span[r:r + p]
        return {"start": start.view(np.int32), "end": end.view(np.int32),
                "quality": self.quality(seed)[q:q + 2 * p], "genome_length": self.n,
                "seq_length": self.length[2 * r:2 * (r + p)], "bam_id": self.bam_id,
                "is_first": self.is_first}


def _pack(pairs: np.ndarray) -> np.ndarray:
    """Rows of two int32 values as one int64 word each (little-endian: the
    first in the low half)."""
    return pairs.astype(np.int32).view(np.int64).ravel()


def _twice(a: np.ndarray) -> np.ndarray:
    return np.concatenate([a, a])


def _frozen(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False
    return a


@functools.lru_cache(maxsize=2)
def _genome_scale(reads_json: str, stream: int) -> _GenomeScale:
    """The stream's base, kept while the window and the check use it."""
    return _GenomeScale(json.loads(reads_json), stream)
