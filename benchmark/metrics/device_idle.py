"""device_idle: 100 × (1 − busy ÷ window), busy being the union of the
device's kernel and copy intervals in the traced window."""

from ..trace import busy_ns


def read(run):
    if run.trace is None or run.device.type != "cuda" \
            or not run.trace.window_ns:
        return None
    return 100.0 * (1.0 - busy_ns(run.trace) / run.trace.window_ns)
