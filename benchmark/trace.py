"""The traced window: what `torch.profiler` recorded, in plain tuples, and
the arithmetic every per-layer reader shares.

Kernels and copies come with the id of the host operation that launched
them (in a trace that recorded the host's operations); a kernel is
"under" a host range (a `record_function` span of the port, or
autograd's `evaluate_function` events) when its launching operation lies
inside that range on the same thread. The device's busy
time is the union of its kernel and copy intervals (the arithmetic of the
port's `tools/profile_train.device_busy_us`, copied here).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

RUNTIME = ("cuda", "cuLaunch", "Activity Buffer")


@dataclass
class Trace:
    window: tuple[int, int]                  # ns, the traced window
    kernels: list = field(default_factory=list)   # (name, start, end, op id)
    ops: dict = field(default_factory=dict)       # id → (name, start, end, thread)

    @property
    def window_ns(self) -> int:
        return self.window[1] - self.window[0]


def from_profiler(prof, window: tuple[int, int]) -> Trace:
    """A Trace of a `torch.profiler.profile` run, its kernels and copies
    clipped to `window` (ns of `time.time_ns`, the profiler's clock)."""
    kernels, ops = [], {}
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation():
                kernels.append((e.name(), start, end,
                                e.linked_correlation_id()))
        elif not e.name().startswith(RUNTIME):
            # host operations only: a runtime call's id is of another kind
            ops[e.correlation_id()] = (e.name(), start, end,
                                       e.start_thread_id())
    kernels = sorted((k for k in kernels if window[0] <= k[1] < window[1]),
                     key=lambda k: k[1])
    return Trace(window=window, kernels=kernels, ops=ops)


def busy_intervals(trace: Trace) -> list[tuple[int, int]]:
    """The union of the device's kernel and copy intervals, clipped to the
    window, as sorted disjoint (start, end)."""
    lo, hi = trace.window
    out: list[list[int]] = []
    for _, s, e, _ in trace.kernels:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(trace: Trace) -> int:
    return sum(e - s for s, e in busy_intervals(trace))


def kernel_ns(trace: Trace, needles) -> tuple[int, int]:
    """(device ns, count) of the kernels whose name holds any needle."""
    hits = [e - s for name, s, e, _ in trace.kernels
            if any(n in name for n in needles)]
    return sum(hits), len(hits)


def _ranges(trace: Trace, match) -> dict:
    """thread → (sorted starts, ends) of the merged host ranges whose name
    `match` accepts."""
    by_thread: dict = {}
    for name, s, e, t in trace.ops.values():
        if match(name):
            by_thread.setdefault(t, []).append((s, e))
    out = {}
    for t, spans in by_thread.items():
        merged: list[list[int]] = []
        for s, e in sorted(spans):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        out[t] = ([s for s, _ in merged], [e for _, e in merged])
    return out


def under_ns(trace: Trace, match) -> tuple[int, int]:
    """(device ns, count) of the kernels and copies launched by a host
    operation inside a range whose name `match` accepts, on its thread;
    the ns are the union of their intervals (cuDNN runs some kernels side
    by side, so a plain sum would count those twice)."""
    ranges = _ranges(trace, match)
    spans = []
    for _, s, e, op_id in trace.kernels:
        op = trace.ops.get(op_id)
        if op is None or op[3] not in ranges:
            continue
        starts, ends = ranges[op[3]]
        i = bisect.bisect_right(starts, op[1]) - 1
        if i >= 0 and op[2] <= ends[i]:
            spans.append((s, e))
    return union_ns(spans), len(spans)


def union_ns(spans) -> int:
    """The length of the union of (start, end) intervals sorted by start."""
    total, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0)


def breakdown(trace: Trace, labelled: Trace | None = None,
              top: int = 10) -> dict:
    """The device operations that took most time in `trace`, and the idle
    gaps of `labelled` (a trace that holds the host's operations; `trace`
    itself where none is given) summed by the host operation that launched
    the work that ended them (the window's close for the last one), in
    seconds."""
    by_name: dict = {}
    for name, s, e, _ in trace.kernels:
        by_name[name] = by_name.get(name, 0) + (e - s)
    labelled = labelled or trace
    gaps: dict = {}
    lo, hi = labelled.window
    busy = busy_intervals(labelled)
    starts = [k[1] for k in labelled.kernels]
    prev = lo
    for s, e in busy + [(hi, hi)]:
        if s > prev:
            i = bisect.bisect_left(starts, s)
            if s >= hi or i >= len(labelled.kernels):
                label = "window close"
            else:
                op = labelled.ops.get(labelled.kernels[i][3])
                label = op[0] if op else "unknown"
            gaps[label] = gaps.get(label, 0) + (s - prev)
        prev = max(prev, e)

    def tops(d):
        return [[k[:160], v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": tops(by_name), "idle_gaps": tops(gaps)}
