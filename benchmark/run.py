"""The port's benchmark: run one cell once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the checkout's root, on a machine with the cards the cell asks for.
The cell's parts are found by name (``harness/spec.py``). With ``--trace
0`` the result carries the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics, read under ``torch.profiler``. Either way the
window's answers are checked against the plain reference, and the last
line of standard output is one JSON object; the numbers compared, each
beside its limit, end standard error and the result's line.

Exits non-zero with no result where there is no card (or too few), where a
solve's answer never comes back as read indices, and where ``jax``,
``jaxlib``, ``flax`` or the JAX package is loaded once the window closes.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
# the harness, then the port from the checkout's root
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import guard, judge, loop, spec  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str | None:
    """The first card's name and power limit, as ``nvidia-smi`` gives them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def metrics(run, traced: bool) -> dict:
    out = {}
    for m in (run.cell.per_layer if traced else run.cell.end_to_end):
        v = spec.load_metric(m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result(run, checks: dict, traced: bool) -> dict:
    device = {"platform": "gpu", "kind": run.kind, "count": run.cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    res = {"correct": run.failed == 0 and bool(run.answers) and judge.passed(checks),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics(run, traced), "device": device}
    if traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s()
        res["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    spans = sorted(run.spans)
    res["detail"] = {"workload": run.cell.name, "seed": run.seed, "samples": len(run.reads),
                     "window_s": run.window_s, "first_span_s": run.spans[0] if run.spans else None,
                     "span_min_s": spans[0] if spans else None,
                     "span_max_s": spans[-1] if spans else None,
                     "making_median_s": statistics.median(run.making) if run.making else None,
                     "card": power_limit(), "setup_parts_s": run.setup_parts,
                     "errors": run.errors[:3]}
    res["checks"] = checks  # last: the numbers compared, each beside its limit
    return res


def run_cell(cell, args, make_solver, cuda: bool = True, t_start: float = T_START) -> int:
    """Measure, check, refuse a process that loaded JAX, print the result."""
    run = loop.measure(cell, args.seed, args.seconds, bool(args.trace), make_solver, t_start,
                       cuda=cuda)
    t0 = time.perf_counter()
    checks = loop.check(run)
    check_s = time.perf_counter() - t0
    found = guard.forbidden_modules()
    if found:
        print(f"refused: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    res = result(run, checks, bool(args.trace))
    res["detail"]["check_s"] = check_s
    print("setup " + " ".join(f"{k} {v:.3f} s" for k, v in run.setup_parts.items()),
          file=sys.stderr)
    for err in run.errors:
        print(f"failed: {err}", file=sys.stderr)
    print(f"attempted {run.attempted} failed {run.failed} correct {res['correct']}",
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.Cell(args.workload)
    problem = guard.card_problem(cell.chips)
    if problem is not None:
        print(f"refused: {problem}; the benchmark measures the card only", file=sys.stderr)
        return 2
    return run_cell(cell, args, loop.registry_solver)


if __name__ == "__main__":
    sys.exit(main())
