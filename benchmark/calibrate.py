"""Read the numbers that a cell's check compares, to set its limits:

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control 4,5,6] [--faults unchanged,half_batch,altered] \
        [--fault-seeds 7,8,9] [--seconds 1]

In one process on the card: the port on each seed (the lower readings),
the control (the plain reference in TF32 in the port's place) on each
control seed (the upper readings), and the port with each fault planted
(`faults.py`) on each fault seed. Prints one JSON line a run. The
benchmark's own runs never run this.
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control", type=seeds, default=[])
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)

    from benchmark import faults, harness
    c = harness.cell(args.workload)
    adapter = harness.module("models", c["config"]["model"])
    plan = [("program", s, None) for s in args.seeds]
    plan += [("control", s, adapter.control(c["config"])) for s in args.control]
    for kind in filter(None, args.faults.split(",")):
        plan += [(kind, s, faults.Faulty(adapter.program(c["config"]), kind))
                 for s in args.fault_seeds]
    for kind, seed, program in plan:
        out, run = harness.run_cell(args.workload, seed, args.seconds, False,
                                    program=program)
        print(json.dumps({"cell": args.workload, "kind": kind, "seed": seed,
                          "units": run.units,
                          "checks": {k: v["value"] for k, v in
                                     out["checks"].items()},
                          "metrics": out["metrics"], "notes": run.notes}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
