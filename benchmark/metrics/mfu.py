"""mfu: the whole step's share of the card's fp32 peak: the analytic
FLOPs of the units done in the traced window (`counts/`, from the
configuration's shapes), over the window, over 67 TFLOP/s."""

from . import peak


def read(run):
    p = peak("fp32_flops")
    if run.trace is None or p is None or not run.units:
        return None
    flops = run.units * run.adapter.flops(run.config, run.traffic["entry"],
                                          run.batch)
    return 100.0 * flops / (run.trace.window_ns / 1e9) / p
