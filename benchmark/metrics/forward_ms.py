"""forward_ms: device ms a step of the kernels launched under the port's
`forward` range (`train.rgb.train_step`: `loss_fn`), over the steps run
after the window under the profiler of host operations (`attribute`)."""

from ..trace import under_ns


def read(run):
    if run.attribution is None:
        return None
    ns, n = under_ns(run.attribution, lambda name: name == "forward")
    return ns / 1e6 / run.attribution_units if n else None
