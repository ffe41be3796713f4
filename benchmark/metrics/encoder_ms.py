"""encoder_ms: device ms a batch of the kernels launched under the port's
`encoder` range (`cli/run_recon_video_rgb.reenact`), over the units
run after the window under the profiler of host operations (`attribute`)."""

from ..trace import under_ns


def read(run):
    if run.attribution is None:
        return None
    ns, n = under_ns(run.attribution, lambda name: name == "encoder")
    return ns / 1e6 / run.attribution_units if n else None
