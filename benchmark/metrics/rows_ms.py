"""rows_ms: device ms a step of the kernels launched under the port's
`sample` and `head_update` ranges (`train.arcface.make_train_step`: the
class draw, its selection and the rows' gather; the rows' SGD and their
scatter back into the table and its momentum), over the steps run after
the window under the profiler of host operations (`attribute`)."""

from ..trace import under_ns

SPANS = ("sample", "head_update")


def read(run):
    if run.attribution is None:
        return None
    ns, n = under_ns(run.attribution, lambda name: name in SPANS)
    return ns / 1e6 / run.attribution_units if n else None
