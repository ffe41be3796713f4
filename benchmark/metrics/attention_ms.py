"""attention_ms: device ms a step of the kernels launched under the port's
`attention` spans (`models/arcface/vit.vit_apply`: each block's ln1, qkv,
the scores' softmax, the product with v, proj, drop path and the
residual; the forward alone, since autograd launches the backward from
its own thread), over the steps run after the window under the profiler
of host operations (`attribute`).

The spans come from the port's own record (`spans.record()`), not from
the profiler's host ranges: where the card's launch queue is full, CUPTI
gives its "Command Buffer Full" events the correlation ids of host
operations, and `trace.from_profiler`, which keys the operations by that
id, loses up to two thirds of the 48 ranges a step. A kernel counts where
the host operation that launched it lies inside a span."""

import bisect

from .. import spans
from ..trace import union_ns


def span_ms(run, name: str):
    """Device ms a unit of the kernels launched inside the port's spans
    called `name`, in the pass after the window; None where there are
    none."""
    trace = run.attribution
    if trace is None:
        return None
    lo, hi = trace.window
    ranges = sorted((s, e) for n, s, e, *_ in spans.record()
                    if n == name and e is not None and lo <= s and e <= hi)
    if not ranges:
        return None
    starts = [s for s, _ in ranges]
    hits = []
    for _, s, e, op_id in trace.kernels:
        op = trace.ops.get(op_id)
        if op is None:
            continue
        i = bisect.bisect_right(starts, op[1]) - 1
        if i >= 0 and op[2] <= ranges[i][1]:
            hits.append((s, e))
    return union_ns(hits) / 1e6 / run.attribution_units if hits else None


def read(run):
    return span_ms(run, "attention")
