"""Observability of the port (counterpart of
hfa_gp_tpu/utils/observability.py): the running-average meter, the
throughput / ETA logger of the arcface trainer, rank-0 logging, and
profiler traces with named regions (`trace`, `annotate`)."""

from __future__ import annotations

import contextlib
import logging
import time

import torch

LOGGER_NAME = "hfa_gp_tpu_torch"


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class ThroughputLogger:
    """samples/sec, ETA, average loss and lr, logged every `freq` steps.
    The first interval only starts the clock."""

    def __init__(self, freq: int, total_steps: int, batch_size: int,
                 writer=None, logger: logging.Logger | None = None):
        self.freq = freq
        self.total_steps = total_steps
        self.batch_size = batch_size
        self.writer = writer
        self.logger = logger or logging.getLogger(LOGGER_NAME)
        self.loss = AverageMeter()
        self._tic = time.time()
        self._init = False
        self._start_step = 0

    def __call__(self, step: int, loss: float, lr: float | None = None):
        self.loss.update(loss)
        if step % self.freq != 0 or step == 0:
            return
        if not self._init:
            self._init = True
            self._start_step = step
            self._tic = time.time()
            return
        elapsed = time.time() - self._tic
        steps = step - self._start_step
        sps = steps * self.batch_size / max(elapsed, 1e-9)
        eta_sec = (self.total_steps - step) / max(steps / elapsed, 1e-9)
        msg = (f"step {step}/{self.total_steps} "
               f"loss {self.loss.avg:.4f} "
               f"{sps:.1f} samples/sec eta {eta_sec / 3600:.2f}h")
        if lr is not None:
            msg += f" lr {lr:.6f}"
        self.logger.info(msg)
        if self.writer is not None:
            self.writer.scalars(step, samples_per_sec=sps,
                                loss_avg=self.loss.avg)
        self.loss.reset()
        self._tic = time.time()
        self._start_step = step


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with `torch.profiler` (host activity, and the
    card's kernels when CUDA is available) and write a Chrome trace,
    `{host}_{pid}.{time}.pt.trace.json`, into `log_dir` (view it in
    TensorBoard's profiler plugin, Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """Named region inside a trace (a no-op outside one)."""
    return torch.profiler.record_function(name)


def init_logging(rank: int = 0, log_file: str | None = None
                 ) -> logging.Logger:
    """Stream logging on rank 0 (warnings only elsewhere) and, when the
    logger is first set up, a file beside it."""
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        if log_file:
            fh = logging.FileHandler(log_file)
            fh.setFormatter(h.formatter)
            logger.addHandler(fh)
    return logger
