"""One run of one cell: set-up, the measured window, the check.

Closed loop, one client: the lab pipeline hands the port one sample after
another, as the reference's CLI takes one BAM at a time. Each sample is
made on the host from ``(seed, index)`` just before it is handed over,
with the clock stopped: making it is the client's work, not the port's,
and the window is the sum of the samples' spans. A sample's span runs from
handing its ``ReadBatch`` to ``solve`` until the read indices are on the
host. The window runs samples until its time reaches ``seconds``; the last
sample finishes inside it. No sample is handed over twice.

The loop keeps only the answers the check will read: a reservoir of
``check_samples``, drawn from the seed (``judge.reservoir_slot``), so that
host memory holds that many answers however long the window runs.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import numpy as np

from harness import generate, judge, trace


def read_batch(sample: dict):
    """The sample as the port's ``ReadBatch``: mates adjacent, first first.
    A sample made at genome scale brings its ``bam_id``, ``seq_length`` and
    ``is_first`` (shared, read-only) in the port's types, so nothing is
    copied."""
    from genome_downsampler_tpu_torch.core.readbatch import ReadBatch

    if "bam_id" in sample:
        bam_id, seq_length, is_first = sample["bam_id"], sample["seq_length"], sample["is_first"]
    else:
        r = len(sample["start"])
        bam_id, is_first = np.arange(r, dtype=np.int64), np.arange(r) % 2 == 0
        seq_length = sample["end"] - sample["start"] + 1
    return ReadBatch(
        bam_id=bam_id, start=sample["start"], end=sample["end"], quality=sample["quality"],
        seq_length=seq_length, is_first=is_first, ref_genome_length=sample["genome_length"])


def registry_solver(name: str):
    """The solver the CLI would build for ``-a name``."""
    from genome_downsampler_tpu_torch.solvers.registry import default_registry

    return default_registry().get(name)


@dataclass
class Run:
    """What one run measured; the metric readers take it."""

    cell: object
    seed: int
    kind: str = "cpu"
    setup_s: float = 0.0
    setup_parts: dict = field(default_factory=dict)  # seconds of each part of set-up
    spans: list = field(default_factory=list)  # seconds a completed sample
    reads: list = field(default_factory=list)  # its reads
    genome: list = field(default_factory=list)  # its genome length
    stats: list = field(default_factory=list)  # the solver's last_stats after it
    answers: dict = field(default_factory=dict)  # window index -> selection, those kept
    making: list = field(default_factory=list)  # seconds to make each window sample's ReadBatch
    attempted: int = 0
    failed: int = 0
    errors: list = field(default_factory=list)
    memory_peak_bytes: int = 0
    trace: trace.DeviceTrace | None = None

    @property
    def window_s(self) -> float:
        return float(sum(self.spans))


def measure(cell, seed: int, seconds: float, traced: bool, make_solver, t_start: float,
            cuda: bool = True) -> Run:
    """Set up, run the window, read the peak and free the solver; the
    check is ``check``'s, after this returns."""
    import torch

    run = Run(cell, seed)
    lap = [t_start]

    def part(name):
        lap.append(time.perf_counter())
        run.setup_parts[name] = lap[-1] - lap[-2]

    part("imports")  # the harness, torch and the look for a card
    if cuda:
        run.kind = torch.cuda.get_device_name(0)
    part("context")
    solver = make_solver(cell.traffic["solver"])
    inner = getattr(solver, "inner", solver)
    m = cell.max_coverage
    reads = cell.config["reads"]
    part("solver")
    batch = read_batch(generate.sample(reads, seed, generate.WARM, 0))
    part("warm_sample")
    # one warm solve, on a sample the window never sees
    solver.solve(m, batch)
    if cuda:
        torch.cuda.synchronize()
    gc.collect()
    part("warm_solve")
    run.setup_s = time.perf_counter() - t_start

    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    keep = int(cell.traffic["check_samples"])
    kept: list = []  # the reservoir's window indices, by slot
    i = 0
    while run.window_s < seconds:
        t0 = time.perf_counter()
        smp = generate.sample(reads, seed, generate.WINDOW, i)
        batch = read_batch(smp)
        run.making.append(time.perf_counter() - t0)
        run.attempted += 1
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(trace.SAMPLE_REGION):
                sel = solver.solve(m, batch)
        except Exception as e:  # an answer that never comes ends the window
            run.spans.append(time.perf_counter() - t0)
            run.failed += 1
            run.errors.append(f"sample {i}: {type(e).__name__}: {e}")
            break
        else:
            run.spans.append(time.perf_counter() - t0)
            run.reads.append(len(smp["start"]))
            run.genome.append(smp["genome_length"])
            run.stats.append(getattr(inner, "last_stats", None))
            slot = judge.reservoir_slot(seed, i, keep)
            if slot is not None:
                if slot < len(kept):
                    del run.answers[kept[slot]]
                    kept[slot] = i
                else:
                    kept.append(i)
                run.answers[i] = sel
        del smp, batch
        i += 1
    if prof is not None:
        prof.stop()
        run.trace = trace.read_profile(prof)
    if cuda:
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    del solver, inner
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return run


def check(run: Run) -> dict:
    """The cell's checks over the window's answers (``judge.judge``)."""
    return judge.judge(run.cell, run.seed, run.answers)
