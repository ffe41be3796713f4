"""backward_ms: device ms a step of the kernels launched under autograd's
`evaluate_function` events (the backward pass), over the steps run after
the window under the profiler of host operations (`attribute`)."""

from ..trace import under_ns

PREFIX = "autograd::engine::evaluate_function"


def read(run):
    if run.attribution is None:
        return None
    ns, n = under_ns(run.attribution, lambda name: name.startswith(PREFIX))
    return ns / 1e6 / run.attribution_units if n else None
