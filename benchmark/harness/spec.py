"""Find a cell's parts by name: ``BENCHMARK.json`` at the checkout's root
names the cells; each configuration, traffic mix, limit set, check and
metric is a file of its own under ``benchmark/``, so a later cell adds
files and entries and edits none.

- ``BENCHMARK.json``'s ``configs[].file``: the deployment (the ``reads``
  block the generator draws, ``max_coverage``, the guarantees);
- ``generators/<name>.py``: ``layout(rng, **reads) -> (start, end)``, the
  reads of one sample, named by the configuration's ``reads`` block;
- ``traffic/<mix>.json``: the solver's registry name, how many answers the
  check samples and the control that its limits were read against;
- ``controls/<name>.py``: ``select(sample, m) -> indices``, a selection put
  in the program's place to read a limit's upper end (``tools/readings.py``);
- ``limits/<cell>.json``: each compared number's limit, by check name;
- ``checks/<name>.py``: ``measure(answer) -> float``, one number of one
  answer, the cell's reading being the worst over the answers checked;
- ``metrics/<name>.py``: ``read(run) -> float | None``, one metric of one
  run (``None``: nothing to read, and the metric is left out).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


def _module(kind: str, name: str):
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_generator(name: str):
    return _module("generators", name)


def load_control(name: str):
    return _module("controls", name)


def load_check(name: str):
    return _module("checks", name)


def load_metric(name: str):
    return _module("metrics", name)


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, workload: str, bench: dict | None = None):
        bench = _json(ROOT / "BENCHMARK.json") if bench is None else bench
        by_name = {w["name"]: w for w in bench["workloads"]}
        if workload not in by_name:
            raise KeyError(f"unknown workload {workload!r}; known: {sorted(by_name)}")
        self.name = workload
        self.workload = by_name[workload]
        conf = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        self.config = _json(ROOT / conf["file"])
        self.traffic = _json(BENCH_DIR / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = _json(BENCH_DIR / "limits" / f"{workload}.json")
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if self._reports(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if self._reports(m) and m["moves"] in reported]

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    @property
    def max_coverage(self) -> int:
        return int(self.config["max_coverage"])
