"""frame_p95_ms: the 95th percentile, over every batch of the window, of
the time from its submission to its frames on the host (a frame's latency
at batch 1)."""

import statistics


def read(run):
    if run.traffic["entry"] != "serve" or len(run.latencies) < 20:
        return None
    return 1e3 * statistics.quantiles(run.latencies, n=20)[-1]
