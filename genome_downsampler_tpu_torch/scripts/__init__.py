"""The port's kernel-experiment entry points, counterparts of the JAX
package's ``scripts/kernel_variants.py`` and ``scripts/bench_kernel_ablate.py``:

    python -m genome_downsampler_tpu_torch.scripts.kernel_variants
    python -m genome_downsampler_tpu_torch.scripts.bench_kernel_ablate [reads_M] [W[:B]] ...

Both need a CUDA card and raise without one. Each exposes ``run(device,
...)``, which the CPU tests drive with the plain twins at a small size.
"""

from __future__ import annotations

import time

import torch


def best_ms(fn, device, reps: int = 5, *, warm: bool = True):
    """``(fn(), ms)``: one warm call (unless ``warm`` is false), then the
    least of ``reps`` timed calls. On a CUDA ``device`` the calls are
    queued back to back between CUDA events, with one synchronize at the
    end, so a call's time is the device's from one event to the next and
    the host's launch overhead hides behind the queued work; on the CPU it
    is the host clock."""
    out = fn() if warm else None
    if torch.device(device).type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        events[0].record()
        for e in events[1:]:
            out = fn()
            e.record()
        torch.cuda.synchronize()
        times = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    else:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return out, min(times)
