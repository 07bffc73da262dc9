"""The readings a cell's limits are set from, at the cell's own size, on the
card: for each seed, the window's first sample solved by the program, the
cell's control (``controls/<name>.py``) in the program's place, and the
program with each fault planted; each of the cell's checks on each.

    python3 benchmark/tools/readings.py --workload <name> --seeds 1,2,3

One JSON line a seed. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[2])]

from harness import faults, generate, guard, judge, loop, spec  # noqa: E402


def numbers(cell, sample, selection) -> dict:
    ans = judge.Answer(sample, selection, cell.max_coverage)
    return {name: spec.load_check(name).measure(ans) for name in cell.limits}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    args = p.parse_args(argv)
    cell = spec.Cell(args.workload)
    problem = guard.card_problem(cell.chips)
    if problem is not None:
        print(f"refused: {problem}", file=sys.stderr)
        return 2
    solver = loop.registry_solver(cell.traffic["solver"])
    control = spec.load_control(cell.traffic["control"]).select
    m = cell.max_coverage
    for seed in (int(s) for s in args.seeds.split(",")):
        smp = generate.sample(cell.config["reads"], seed, generate.WINDOW, 0)
        batch = loop.read_batch(smp)
        out = {"workload": cell.name, "seed": seed,
               "program": numbers(cell, smp, solver.solve(m, batch)),
               "control": {cell.traffic["control"]: numbers(cell, smp, control(smp, m))},
               "faults": {f: numbers(cell, smp, faults.Faulty(solver, f).solve(m, batch))
                          for f in faults.FAULTS}}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
