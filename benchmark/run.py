"""Run one cell of the benchmark of hfa_gp_tpu_torch once, on this
machine's card, and print its result as the last line of standard output:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

With `--trace 0` the line carries the cell's end-to-end metrics; with
`--trace 1` `torch.profiler` records the window's device kernels and
copies (and, after the window, about a second of units with the host's
operations too), and the line carries the per-layer metrics, the
device's busy and window seconds, and a breakdown. Set-up's phases go
to standard error. The numbers the correctness check compared, each with its
limit, end standard error and the line (under "checks"). Exits 1, with
no result, without a CUDA card or with fewer than the cell asks for, or
when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys

gc.disable()    # no collector passes over set-up's imports; on from the window

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = ROOT                 # import `benchmark` and the port
else:
    sys.path.insert(0, ROOT)
os.environ.setdefault("USE_FLAX", "0")
# Python's bytecode of every module this process imports, torch's too,
# kept at a fixed path in the checkout: where PYTHONDONTWRITEBYTECODE is
# set and the installed packages carry no bytecode, each process would
# otherwise compile torch's sources anew (seconds of set-up that swing
# with the host's load); here only a checkout's first run compiles them.
sys.pycache_prefix = os.path.join(ROOT, ".pyc_cache")
sys.dont_write_bytecode = False


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness
    c = harness.cell(args.workload)
    chips = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run: the cell asks for {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 1
    out, run = harness.run_cell(args.workload, args.seed, args.seconds,
                                bool(args.trace))
    prev, phases = 0.0, []
    for phase, age in run.phases + [("window start", run.setup_s)]:
        phases.append(f"{phase} {age - prev!r}")
        prev = age
    print(f"run: set-up phases (s): {'; '.join(phases)}", file=sys.stderr)
    if run.trace is not None and run.trace.kernels:
        lo, hi = run.trace.window
        ks = run.trace.kernels
        print(f"run: traced window: {len(ks)} device operations over "
              f"{run.units} units, the first starting "
              f"{(ks[0][1] - lo) / 1e6!r} ms after it opens, the last ending "
              f"{(hi - max(k[2] for k in ks)) / 1e6!r} ms before it closes",
              file=sys.stderr)
    if run.attribution is not None:
        print(f"run: {run.attribution_units} units after the window under the"
              f" profiler of host operations", file=sys.stderr)
    if run.latencies:
        print(f"run: latency median {1e3 * statistics.median(run.latencies)!r}"
              f" ms over {len(run.latencies)} batches", file=sys.stderr)
    print(f"run: peak device memory {run.memory_peak_bytes} bytes; "
          f"launches in the window {run.launches}", file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        print(f"run: JAX or the JAX package was loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 1
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
