"""Observability of the port (counterpart of
hfa_gp_tpu/utils/observability.py): the running-average meter, the
throughput / ETA logger of the arcface trainer, rank-0 logging, and
profiler traces with named regions (`trace`, `annotate`).

While a `torch.profiler` profile records, with any activities, each
`annotate` region is also kept in memory on `time.time_ns`, the clock
that kineto stamps its events with, so that the port's own spans can be
laid beside the card's kernels (`spans`, `drain`). With no profile
recording, `annotate` costs one flag check.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

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


# The record holds the newest spans: 2**16 is over 60 s of batch-1
# reenactment (7 spans a frame at ~30 frames/s).
RECORD_SPANS = 1 << 16


class _Stack(threading.local):
    """Each thread's open spans, outermost first."""

    def __init__(self):
        self.open: list = []


class _Record:
    """The spans entered while a profile records, oldest dropped first.
    Each entry is [name, start_ns, end_ns, parent seq, unit seq, thread,
    seq]; `seq` numbers the spans in the order they were entered."""

    def __init__(self, maxlen: int):
        self.entries: collections.deque = collections.deque(maxlen=maxlen)
        self.seq = itertools.count()
        self.stack = _Stack()

    def spans(self) -> list[tuple]:
        held = list(self.entries)
        at = {e[6]: i for i, e in enumerate(held)}
        return [(name, start, end, at.get(parent), at.get(unit), thread)
                for name, start, end, parent, unit, thread, _ in held]


_RECORD = _Record(RECORD_SPANS)


class _Span:
    """`record_function(name)`, and inside it the span's entry in the
    record, stamped on `time.time_ns`."""

    __slots__ = ("name", "function", "entry")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.function = torch.profiler.record_function(self.name)
        self.function.__enter__()
        stack = _RECORD.stack.open
        seq = next(_RECORD.seq)
        self.entry = [self.name, time.time_ns(), None,
                      stack[-1][6] if stack else None,
                      stack[0][6] if stack else seq,
                      threading.get_ident(), seq]
        _RECORD.entries.append(self.entry)
        stack.append(self.entry)
        return self

    def __exit__(self, *exc):
        self.entry[2] = time.time_ns()
        _RECORD.stack.open.pop()
        return self.function.__exit__(*exc)


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """Named region inside a trace: a `record_function` range, and an entry
    of the span record (`spans`). Outside a recording profile it enters
    nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def spans() -> list[tuple]:
    """The spans recorded while a profile recorded, in the order they were
    entered: (name, start_ns, end_ns, parent, unit, thread). `parent` is
    the index in this list of the enclosing span on the same thread,
    `unit` that of the outermost one (a span's own index when it is
    outermost); either is None where that span was dropped or there is
    none. `end_ns` is None while a span is open; `thread` is
    `threading.get_ident()`."""
    return _RECORD.spans()


def drain() -> list[tuple]:
    """`spans()`, then an empty record."""
    out = _RECORD.spans()
    _RECORD.entries.clear()
    return out


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
