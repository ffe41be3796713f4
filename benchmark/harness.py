"""One run of one cell: find its files by name, set it up, measure its
window, check what the window produced against the reference, and
compute the cell's metrics.

A cell is an entry of `workloads` in the root `BENCHMARK.json`: its
configuration `configs/<config>.json` names the model's adapter
(`models/<model>.py`), its traffic `traffic/<traffic>.json` names the
entry that drives it (`entries/<entry>.py`), and `limits/<cell>.json`
holds the limit of each number its check compares. A metric is read by
`metrics/<name before its first dot>.py`.

The adapter contract. An adapter is a module that the entries and
readers reach only through these names, so that a new model's cell is
new files alone:

  * `spec(config)` → [(path, shape, kind, arg)]: the weights, in the
    program's param-tree layout, for `weights.make` (its kinds);
  * `inputs(config, traffic, seed, device)` → {name: (P, …) tensor}: the
    pool of inputs, made on the device from the seed, that
    `inputs.batches` cuts into the batches of the traffic's "batch";
  * `aux_spec(config)`, optional → a spec or None: a second tree of fixed
    weights that a loss reads (the avatars' LPIPS), drawn on a stream of
    its own;
  * `program(config)`, `reference(config)`, `control(config)`: the system
    under test, its plain reference, and the reference a precision lower
    (the control that the check must fail). Each gives `wrap(tree)` and
    `serve(params, batch)` to be served, or `trainer(tree, aux_tree or
    None, paths)` to be trained: an object with `leaves` (the trained
    tensors, in the spec's order of `paths`), `step(batch)` → the loss,
    and `first_grads()` (the first step's gradients as the optimizer got
    them, read from its state: Adam's first moment, SGD's momentum);
  * `flops(config, entry, batch)`: the work of one unit, counted from the
    shapes, which `metrics/mfu.py` reads;
  * `kernel_counters()` → {kernel: (forward, backward)}: the program's
    launch counters, which the roofline readers hold the trace to;
  * `ALTERED_LEAF`, for a trained model: the path (its end) of the leaf
    whose gradient `faults.py`'s `altered` scales.

A training configuration adds `configs/<config>.json`, `models/<model>.py`
with its reference under `reference/` and its counts under `counts/`,
`traffic/<traffic>.json` naming the `fit` entry, `limits/<cell>.json`,
any readers under `metrics/`, and its entries in `BENCHMARK.json`.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import math
import os
import sys
import time

import torch

from . import trace as trace_mod

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
FORBIDDEN = ("jax", "jaxlib", "flax", "hfa_gp_tpu")
ATTRIBUTION_S = 1.0


def load_json(*parts) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def manifest() -> dict:
    with open(MANIFEST) as f:
        return json.load(f)


def module(kind: str, name: str):
    """`benchmark/<kind>/<name>.py`, imported by name."""
    return importlib.import_module(f"{__package__}.{kind}.{name}")


def reader(metric: str):
    """The reader of a metric: the file of the name before its first dot
    (`device_idle.fit` → `metrics/device_idle.py`)."""
    return module("metrics", metric.split(".")[0])


def cell(name: str) -> dict:
    """Everything one cell names: its entry in the manifest, the
    configuration, the traffic, the limits, and the metrics it reports
    ("end_to_end" and "per_layer" lists of the manifest's entries)."""
    bench = manifest()
    hits = [w for w in bench["workloads"] if w["name"] == name]
    if not hits:
        raise KeyError(f"no workload {name!r} in {MANIFEST}")
    w = hits[0]

    def mine(m):
        return name in m.get("workloads", [name])

    return {"workload": w,
            "config": load_json("configs", f"{w['config']}.json"),
            "traffic": load_json("traffic", f"{w['traffic']}.json"),
            "limits": load_json("limits", f"{name}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


class Run:
    """What one run records; entries fill it, readers read it."""

    def __init__(self, c: dict, seed: int, seconds: float, traced: bool,
                 device: str, program):
        self.cell, self.seed, self.seconds = c, seed, seconds
        self.config, self.traffic = c["config"], c["traffic"]
        self.traced, self.device = traced, torch.device(device)
        self.adapter = module("models", self.config["model"])
        self.program = program if program is not None \
            else self.adapter.program(self.config)
        self.units = 0                 # batches served or steps trained
        self.latencies: list[float] = []
        self.setup_s = self.window_s = None
        self.phases: list[tuple[str, float]] = []
        self.trace: trace_mod.Trace | None = None
        self.attribution: trace_mod.Trace | None = None
        self.attribution_units = 0
        self.launches: dict = {}
        self.memory_peak_bytes = 0
        self.notes: dict = {}          # what the check found, for calibrate.py
        self._t0 = None

    @property
    def batch(self) -> int:
        return self.traffic["batch"]

    @property
    def frames(self) -> int:
        return self.units * self.batch

    def mark(self, phase: str):
        """The end of a phase of set-up, as the process's age."""
        self._sync()
        self.phases.append((phase, process_age_s()))

    def done(self) -> bool:
        """Whether the window's time is up (checked before each unit)."""
        return time.perf_counter() - self._t0 >= self.seconds

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profiler(self, host_ops: bool):
        """A profiler of the device's kernels and copies; of the host's
        operations too where `host_ops` (or where there is no card)."""
        from torch.profiler import ProfilerActivity, profile
        if self.device.type != "cuda":
            return profile(activities=[ProfilerActivity.CPU])
        acts = [ProfilerActivity.CPU] if host_ops else []
        return profile(activities=acts + [ProfilerActivity.CUDA])

    @contextlib.contextmanager
    def window(self):
        """The measured window: the device idle at its start, synchronised
        at its end. When the run is traced, the profiler records the
        device's kernels and copies alone, so that the host runs as it
        does untraced (the host's operations cost microseconds each to
        record; `attribute` records them after the window)."""
        self._sync()
        counters = self._counters()
        gc.collect()
        gc.freeze()                    # set-up's objects out of the collector
        gc.enable()                    # which `run.py` keeps off in set-up
        prof = self._profiler(host_ops=False) if self.traced else None
        if prof is not None:
            prof.__enter__()
        self.setup_s = process_age_s()
        start_ns = time.time_ns()      # the profiler's clock
        self._t0 = time.perf_counter()
        yield
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        end_ns = time.time_ns()
        gc.unfreeze()
        self.memory_peak_bytes = torch.cuda.max_memory_allocated(self.device) \
            if self.device.type == "cuda" else 0
        after = self._counters()
        self.launches = {k: tuple(a - b for a, b in zip(after[k], counters[k]))
                         for k in after}
        if prof is not None:
            prof.__exit__(None, None, None)
            self.trace = trace_mod.from_profiler(prof, (start_ns, end_ns))

    def attribute(self, unit):
        """After a traced window: `unit(i)` run under the profiler of host
        operations and device kernels alike, for ATTRIBUTION_S seconds and
        at least two units, so that readers can attribute device time to
        the program's host ranges (`run.attribution`)."""
        if not self.traced:
            return
        self._sync()
        prof = self._profiler(host_ops=True)
        prof.__enter__()
        start_ns, t0, n = time.time_ns(), time.perf_counter(), 0
        while n < 2 or time.perf_counter() - t0 < ATTRIBUTION_S:
            unit(n)
            n += 1
        self._sync()
        end_ns = time.time_ns()
        prof.__exit__(None, None, None)
        self.attribution = trace_mod.from_profiler(prof, (start_ns, end_ns))
        self.attribution_units = n

    def _counters(self) -> dict:
        if self.device.type != "cuda":
            return {}
        return self.adapter.kernel_counters()

    def release(self):
        """After the window: free what the program left cached."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def read_metrics(run: Run, metrics: list) -> dict:
    """{name: {"value", "unit"}} of each metric whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value = reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, or the JAX package's
    (compared whole: `hfa_gp_tpu_torch` is the port and passes)."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def run_cell(name: str, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda", program=None,
             cell_override: dict | None = None) -> tuple[dict, Run]:
    """Run one cell once → (the result line as a dict, the Run). `program`
    takes the port's place (the control, or a port with a fault planted);
    `cell_override` replaces the cell's files (the tests' tiny cells)."""
    c = cell_override or cell(name)
    imported = process_age_s()
    if device == "cuda":
        torch.backends.cudnn.allow_tf32 = False       # the configuration's
        torch.backends.cuda.matmul.allow_tf32 = False  # fp32, TF32 off
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    run = Run(c, seed, seconds, traced, device, program)
    run.phases.append(("imports", imported))
    run.mark("device and port")
    entry = module("entries", c["traffic"]["entry"])
    checks = entry.run(run)
    metrics = read_metrics(run, c["per_layer"] if traced else c["end_to_end"])
    limits = c["limits"]
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in checks.items()}
    correct = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                  for v in checks.values())
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else "cpu",
           "count": c["workload"]["chips"],
           "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": correct, "attempted": run.units, "failed": 0,
           "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        dev["busy_s"] = trace_mod.busy_ns(run.trace) / 1e9
        dev["window_s"] = run.trace.window_ns / 1e9
        out["breakdown"] = trace_mod.breakdown(run.trace, run.attribution)
    out["checks"] = checks
    return out, run
