"""What the traced run (``--trace 1``) reads from ``torch.profiler``: the
device's operations (kernels, copies, fills) and the host's named regions
(``bench.sample`` around each solve, the program's own ``annotate``
regions inside it), all on the profiler's one clock.

The window is the union of the ``bench.sample`` regions: the card's busy
time is the union of its operations inside them, and each idle gap inside
them is put down to the innermost named host region that covers its middle.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

SAMPLE_REGION = "bench.sample"
# the program's regions are named ``<part>.<phase>`` (utils/profiling.py::annotate)
_REGION = re.compile(r"^[a-z_]+(\.[a-z_0-9]+)+$")


@dataclass
class DeviceTrace:
    ops: list = field(default_factory=list)  # (name, start_us, end_us) on the card
    regions: list = field(default_factory=list)  # (name, start_us, end_us) on the host

    def op_seconds(self, pattern: str) -> float:
        """Seconds of the card's operations whose name contains ``pattern``."""
        return sum(e - s for n, s, e in self.ops if pattern in n) / 1e6

    def windows(self) -> list:
        return sorted((s, e) for n, s, e in self.regions if n == SAMPLE_REGION)

    def window_s(self) -> float:
        return sum(e - s for s, e in _union(self.windows())) / 1e6

    def busy_intervals(self) -> list:
        """The union of the card's operations, cut to the window."""
        return _intersect(_union([(s, e) for _, s, e in self.ops]), _union(self.windows()))

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def device_ops(self, top: int = 10) -> list:
        total: dict = {}
        for n, s, e in self.ops:
            total[n] = total.get(n, 0.0) + (e - s) / 1e6
        return sorted(([n, v] for n, v in total.items()), key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle seconds inside the window, summed by the innermost named host
        region around each gap's middle."""
        busy = self.busy_intervals()
        regions = sorted((s, e, n) for n, s, e in self.regions)
        starts = [r[0] for r in regions]
        total: dict = {}
        j = 0
        for ws, we in _union(self.windows()):
            inside = regions[bisect.bisect_left(starts, ws):bisect.bisect_right(starts, we)]
            edges = [ws]
            while j < len(busy) and busy[j][1] <= we:
                edges += busy[j]
                j += 1
            edges.append(we)
            for a, b in zip(edges[0::2], edges[1::2]):
                if b <= a:
                    continue
                mid = (a + b) / 2
                name = SAMPLE_REGION
                for s, e, n in inside:  # sorted by start: the last match is innermost
                    if s <= mid <= e:
                        name = n
                total[name] = total.get(name, 0.0) + (b - a) / 1e6
        return sorted(([n, v] for n, v in total.items()), key=lambda x: -x[1])[:top]


def _union(iv: list) -> list:
    out: list = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _intersect(a: list, b: list) -> list:
    """Intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def read_profile(prof) -> DeviceTrace:
    """The card's operations and the host's named regions of a finished
    ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    tr = DeviceTrace()
    for ev in prof.events():
        span = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        named = ev.name == SAMPLE_REGION or _REGION.match(ev.name)
        if ev.device_type == DeviceType.CUDA:
            if not named:  # a region's mirror on the card's timeline is no operation
                tr.ops.append(span)
        elif named:
            tr.regions.append(span)
    return tr
