#!/usr/bin/env python3
"""The precision control of a cell, and the readings its limits are set
from.

    python3 benchmark/control.py --workload dfg2d2_transient \
        --seeds 11,12,13 --seconds 5 [--control-seeds 11,12,13] \
        [--out control.json]

For each seed, one short run of the cell (benchmark/run.py's execute),
then from the same states:

- program: the judge's numbers of the program's first, judged and last
  steps;
- control: the reference put in the program's place, computed in the
  nearest precision below the configuration's (bfloat16 for float32,
  float32 for float64; Newton to its own rounding floor), judged
  against the float64 reference like the program (only for the
  control seeds);
- unchanged: the first, the judged and the last steps' states left as
  they were before the step (judged_du reads 1 by its definition).

Prints one JSON line a seed and writes them all to --out. This is no
part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
LOWER = {"float32": "bfloat16", "float64": "float32"}


def control_readings(config, cell, mesh, device, states) -> dict:
    """The control's numbers: the reference in the lower precision from
    the program's start state and from its states before the judged and
    the last window steps, judged against the float64 reference like the
    program."""
    import torch

    from benchmark import cell as cellmod
    from benchmark import judge

    start, _, judged, last, ref = states
    low = getattr(torch, LOWER[config["dtype"]])
    prob = cellmod.make_problem(config, cell, mesh, device, dtype=low)
    u1, p1, _ = prob.step(*start)
    uJ, pJ, _ = prob.step(judged[0], judged[1])
    uN, pN, _ = prob.step(last[0], last[1])
    return judge.compare((u1, p1), (judged[0], judged[1], uJ, pJ),
                         (last[0], last[1], uN, pN), ref)


def unchanged_readings(states) -> dict:
    """The numbers of steps that return the state they were given."""
    from benchmark import judge

    start, _, judged, last, ref = states
    jp, lp = (judged[0], judged[1]), (last[0], last[1])
    return judge.compare(start, jp + jp, lp + lp, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    ap.add_argument("--config-patch", default="{}",
                    help="JSON updating the configuration (small CPU runs)")
    ap.add_argument("--cell-patch", default="{}",
                    help="JSON updating the cell file (small CPU runs)")
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import run

    run.set_cache_dirs()
    from benchmark import cell as cellmod

    config_patch = json.loads(args.config_patch)
    cell_patch = json.loads(args.cell_patch)
    _, _, cell, config = cellmod.resolve(args.workload, config_patch,
                                         cell_patch)
    mesh = cellmod.make_mesh(config)
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        result, chk, info = run.execute(
            args.workload, seed, args.seconds, 0, device=args.device,
            config_patch=config_patch, cell_patch=cell_patch)
        row = {"seed": seed, "failed": result["failed"],
               "steps": info["steps"],
               "program": {k: c["value"] for k, c in chk.items()},
               "reference_s": info.get("reference_s"),
               "newton": info["newton_per_step"], "ksp": info["ksp_per_step"]}
        states = info.get("states")
        row["judged_step"] = info.get("judged_step")
        if states is not None:
            row["unchanged"] = unchanged_readings(states)
            if seed in control_seeds:
                row["control"] = control_readings(config, cell, mesh,
                                                  args.device, states)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
