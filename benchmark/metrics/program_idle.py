"""program_idle: 100 × the traced window's idle time (no kernel or copy
running) that falls inside the port's outermost spans (a batch's
`reenact` or `audio_sample`, a step's `train_step`) ÷ the window, by
`spans.idle_split`. `device_idle − program_idle` is the idle time that is
not the port's: the harness's loop and its copy of the frames to the
host."""

from .. import spans


def read(run):
    if run.trace is None or run.device.type != "cuda" \
            or not run.trace.kernels or not run.trace.window_ns:
        return None
    split = spans.idle_split(spans.record(), run.trace)
    if split is None:
        return None
    inside = sum(split.values()) - split.get(spans.OUTSIDE, 0)
    return 100.0 * inside / run.trace.window_ns
