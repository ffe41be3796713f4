"""The card's name and power limit, and CUDA-event timing, for the
sampler probe (`probe_sampler`) and the card-side smoke test
(`chip_smoke.py`)."""

from __future__ import annotations

import subprocess

import numpy as np
import torch


def card_line() -> str:
    """`nvidia-smi`'s name and power limit of the first card, the line to
    keep beside every number measured on it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def events_ms(fn) -> float:
    """Device time of one fn(), between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def device_ms(fn, iters: int = 20, warmup: int = 3,
              span_ms: float = 2.0) -> float:
    """Device time of one fn(): the median of `iters` CUDA-event timings of
    a run of back-to-back calls, over the run's length. A run lasts about
    `span_ms` (at least one call, at most 20), so the host's time to issue
    a call hides behind the card's work on the calls before it, as on a
    path whose host runs ahead of the card; a call that takes longer than
    `span_ms` is timed alone."""
    for _ in range(warmup):
        fn()
    reps = max(1, min(20, int(span_ms / max(events_ms(fn), 1e-3))))

    def run():
        for _ in range(reps):
            fn()

    return float(np.median([events_ms(run) for _ in range(iters)])) / reps
