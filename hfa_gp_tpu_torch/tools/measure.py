"""What the card-side tools share: the card's name and power limit, and
CUDA-event timing."""

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


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of `iters` timings of fn(), after warm-up."""
    for _ in range(warmup):
        fn()
    return float(np.median([events_ms(fn) for _ in range(iters)]))
