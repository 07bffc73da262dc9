"""Whether the window's answers are right: a sample of them, drawn from the
seed, each held by the cell's checks to the plain reference.

Each check (``checks/<name>.py``) gives one number of one answer; the
cell's reading is the worst (largest) over the answers checked, held to
its limit in ``limits/<cell>.json``.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np

from harness import generate, reference, spec


class Answer:
    """One sample's selection beside what the reference works out for it."""

    def __init__(self, sample: dict, selection, m: int):
        self.sample = sample
        self.selection = np.asarray(selection).ravel()
        self.m = m
        self.reads = len(sample["start"])

    @cached_property
    def kept(self) -> np.ndarray:
        """The distinct selected reads that exist."""
        sel = self.selection.astype(np.int64)
        return np.unique(sel[(sel >= 0) & (sel < self.reads)])

    @cached_property
    def target(self) -> np.ndarray:
        return reference.target(self.sample, self.m)

    @cached_property
    def coverage_out(self) -> np.ndarray:
        s = self.sample
        return reference.coverage(s["start"], s["end"], s["genome_length"], self.kept)

    @cached_property
    def least_cost(self) -> int:
        return reference.least_cost(self.sample, self.target)

    @cached_property
    def cost(self) -> int:
        return int(reference.costs(self.sample)[self.kept].sum())


def checked_indices(seed: int, completed, k: int) -> list:
    """``k`` of the ``completed`` window samples' indices (all, if fewer),
    drawn from the seed."""
    completed = sorted(completed)
    if len(completed) <= k:
        return completed
    rng = generate.rng_for(seed, generate.CHECK)
    return sorted(completed[int(j)] for j in rng.choice(len(completed), size=k, replace=False))


def reservoir_slot(seed: int, n: int, k: int) -> int | None:
    """Where the window's ``n``-th completed answer (from 0) goes in a
    reservoir of ``k`` (a slot to fill or replace), or None where it is not
    kept: each draw comes from the seed and ``n`` alone, so the answers
    kept are a uniform sample of the window's, chosen without knowing its
    length. With no more than ``k`` answers kept, ``checked_indices``
    takes them all."""
    if n < k:
        return n
    j = int(generate.rng_for(seed, generate.CHECK, n + 1).integers(n + 1))
    return j if j < k else None


def judge(cell, seed: int, answers: dict) -> dict:
    """``{check: {"value", "limit"}}`` over the answers (window index ->
    selection) of the indices ``checked_indices`` draws."""
    idx = checked_indices(seed, answers, int(cell.traffic["check_samples"]))
    checks = {name: spec.load_check(name) for name in cell.limits}
    worst = {name: None for name in checks}
    for i in idx:
        ans = Answer(generate.sample(cell.config["reads"], seed, generate.WINDOW, i),
                     answers[i], cell.max_coverage)
        for name, mod in checks.items():
            v = mod.measure(ans)
            worst[name] = v if worst[name] is None else max(worst[name], v)
    return {name: {"value": worst[name], "limit": cell.limits[name]} for name in checks}


def passed(checks: dict) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
