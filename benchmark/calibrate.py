"""Read the numbers that a cell's check compares, to set its limits:

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control 4,5,6] [--faults unchanged,half_batch,altered] \
        [--fault-seeds 7,8,9] [--seconds 1]

In one process on the card: the port on each seed (the lower readings),
the control (the adapter's `control`: its plain reference a precision
lower, in the port's place) on each control seed (the upper readings),
and the port with each fault planted (`faults.py`) on each fault seed.
Prints one JSON line a run. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = ROOT
else:
    sys.path.insert(0, ROOT)


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def readings(c: dict, seeds, control=(), kinds=(), fault_seeds=(),
             seconds: float = 1.0, device: str = "cuda"):
    """Each run of the plan on the cell `c` (as `harness.cell` gives it):
    yields (kind, seed, result line, Run), kind "program", "control" or a
    fault's. The adapter's program or control stands in the port's place;
    nothing here assumes a second tree or a model."""
    from benchmark import faults, harness
    name = c["workload"]["name"]
    adapter = harness.module("models", c["config"]["model"])
    plan = [("program", s, None) for s in seeds]
    plan += [("control", s, adapter.control(c["config"])) for s in control]
    for kind in kinds:
        plan += [(kind, s, faults.planted(adapter, c["config"], kind))
                 for s in fault_seeds]
    for kind, seed, program in plan:
        out, run = harness.run_cell(name, seed, seconds, False, device=device,
                                    program=program, cell_override=c)
        yield kind, seed, out, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control", type=seeds, default=[])
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)

    from benchmark import harness
    c = harness.cell(args.workload)
    kinds = [k for k in args.faults.split(",") if k]
    for kind, seed, out, run in readings(c, args.seeds, args.control, kinds,
                                         args.fault_seeds, args.seconds):
        print(json.dumps({"cell": args.workload, "kind": kind, "seed": seed,
                          "units": run.units,
                          "checks": {k: v["value"] for k, v in
                                     out["checks"].items()},
                          "metrics": out["metrics"], "notes": run.notes}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
