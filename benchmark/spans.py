"""The port's own spans beside a traced window.

While a `torch.profiler` profile records, the port keeps each of its
`observability.annotate` ranges in memory on `time.time_ns`, the clock
the window is bounded with and CUPTI's kernel times are read on
(`hfa_gp_tpu_torch.utils.observability.spans`): (name, start_ns, end_ns,
parent, unit, thread), `unit` the index of the outermost span, which
holds one batch or one step. Here the window's idle time, the complement
of `trace.busy_intervals`, is put down to what the host was doing: the
innermost span it was in, a unit between its spans, or outside every
unit (the harness's loop and its copy of the frames to the host).

A port without the record (a build before it) gives no spans, and every
function here then finds nothing.
"""

from __future__ import annotations

from .trace import Trace, busy_intervals

BETWEEN = "inside a unit, between spans"
OUTSIDE = "outside every unit"


def record() -> list:
    """The port's span record, or [] where the port keeps none."""
    from hfa_gp_tpu_torch.utils import observability
    spans = getattr(observability, "spans", None)
    return spans() if spans is not None else []


def units(spans: list, window: tuple[int, int]) -> list[tuple]:
    """The outermost spans that lie wholly inside `window`: (name, start_ns,
    end_ns), in the order they were entered."""
    lo, hi = window
    return [(name, s, e) for i, (name, s, e, _, unit, _) in enumerate(spans)
            if unit == i and e is not None and lo <= s and e <= hi]


def idle_intervals(trace: Trace) -> list[tuple[int, int]]:
    """The window's intervals in which no kernel or copy ran."""
    lo, hi = trace.window
    out, prev = [], lo
    for s, e in busy_intervals(trace) + [(hi, hi)]:
        if s > prev:
            out.append((prev, s))
        prev = max(prev, e)
    return out


def _segments(spans: list, window: tuple[int, int]) -> list[tuple]:
    """The host's timeline over `window` as sorted disjoint (start, end,
    label): the name of the innermost span open there (the deepest; of
    two threads', the one entered last), BETWEEN where that is a unit
    itself, OUTSIDE where none is open."""
    lo, hi = window
    depth, live = {}, []
    for i, (name, s, e, parent, unit, _) in enumerate(spans):
        depth[i] = 0 if unit == i else depth.get(parent, 0) + 1
        if e is not None and s < hi and e > lo:
            live.append((max(s, lo), min(e, hi), i))
    if not live:
        return []
    edges = sorted({lo, hi, *(t for s, e, _ in live for t in (s, e))})
    starts = sorted(live)
    out, open_, k = [], [], 0
    for a, b in zip(edges, edges[1:]):
        while k < len(starts) and starts[k][0] <= a:
            open_.append(starts[k])
            k += 1
        open_ = [x for x in open_ if x[1] > a]
        if open_:
            i = max(open_, key=lambda x: (depth[x[2]], x[0]))[2]
            label = BETWEEN if depth[i] == 0 else spans[i][0]
        else:
            label = OUTSIDE
        if out and out[-1][2] == label and out[-1][1] == a:
            out[-1] = (out[-1][0], b, label)
        else:
            out.append((a, b, label))
    return out


def idle_split(spans: list, trace: Trace) -> dict | None:
    """{label: idle ns} of the window (`_segments`' labels), or None where
    no span of the record overlaps the window."""
    segments = _segments(spans, trace.window)
    if not segments:
        return None
    out: dict = {}
    j = 0
    for s, e in idle_intervals(trace):
        while j < len(segments) and segments[j][1] <= s:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < e:
            a, b, label = segments[k]
            ns = min(b, e) - max(a, s)
            if ns > 0:
                out[label] = out.get(label, 0) + ns
            k += 1
    return out
