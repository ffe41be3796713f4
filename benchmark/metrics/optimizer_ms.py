"""optimizer_ms: device ms a step of the kernels launched under the port's
`optimizer` range (`train.rgb.train_step`: the freeze gate and Adam),
over the steps run after the window under the profiler of host
operations (`attribute`)."""

from ..trace import under_ns


def read(run):
    if run.attribution is None:
        return None
    ns, n = under_ns(run.attribution, lambda name: name == "optimizer")
    return ns / 1e6 / run.attribution_units if n else None
