"""Inference stages replayed as CUDA graphs.

The port issues its forward from Python one op at a time, and at small
batches the host takes longer to launch a stage's kernels than the card
takes to run them. `run(stage, fn, params, *inputs, static=...)` runs
`fn(params, *inputs, *static)`, a stage of tensors in, tensors out:

  * eagerly where a graph cannot hold it: an input off the card, autograd
    recording, a capture already under way, or a caller that says so
    (`enabled=False`: a model axis' collectives, a generator's draws);
  * eagerly the first time it sees a key, on a stream of its own (the
    capture's warm-up), so that a one-off shape, such as a video's last
    partial batch, is never captured;
  * captured into a CUDA graph the second time, and replayed from then
    on. A stage whose capture fails runs eagerly for that key from then
    on; `stats` counts it and keeps the error.

A key holds what decides the captured work: the stage, `fn`, the address,
shape, stride and dtype of every tensor in `params` (a graph reads them
where they lie, so a parameter changed in place is seen and one replaced
gives a new key), the inputs' shapes, dtypes and device, `static`, the
grad and inference modes and the backends' flags. The inputs are copied
into the graph's own buffers (laid out as the inputs of its capture) and
its outputs copied out, so nothing a caller holds aliases a graph's
memory. A replay runs the kernels `fn` launched at the capture: code
patched under `fn` after it is not seen (`reset` drops every graph). The
kernels' launch counters (`core/kernels/{triplane,raymarch}.LAUNCHES` and
`LAUNCHES_BWD`) advance at each replay by the launches the graph holds.

The graphs share one memory pool; at most `capacity` keys are kept, the
least recently used dropped first. A replay is issued inside the caller's
profiler range, as an operation named "graph_replay" that the profiler
links the graph's kernels to.
"""

from __future__ import annotations

import collections

import torch
from torch import nn
from torch._C._profiler import _RecordFunctionFast

from .kernels import raymarch, triplane

# the launch counters a replay advances
COUNTERS = ((triplane, "LAUNCHES"), (triplane, "LAUNCHES_BWD"),
            (raymarch, "LAUNCHES"), (raymarch, "LAUNCHES_BWD"))

CAPACITY = 32
_FAILED = "failed"          # a key whose capture failed: eager from then on
_SEEN = "seen"              # a key run once, eagerly


def _counters() -> tuple[int, ...]:
    return tuple(getattr(m, name) for m, name in COUNTERS)


def _advance(by) -> None:
    for (m, name), n in zip(COUNTERS, by):
        setattr(m, name, getattr(m, name) + n)


def _leaves(tree, out: list) -> list:
    """The tensors of a param tree (a `ParamTree` or other module, a dict
    of trees, a tensor or None), in a fixed order."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, nn.Module):
        out.extend(t for t in tree._parameters.values() if t is not None)
        out.extend(t for t in tree._buffers.values() if t is not None)
        for m in tree._modules.values():
            _leaves(m, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    return out


def _flags() -> tuple:
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    return (torch.is_grad_enabled(), torch.is_inference_mode_enabled(),
            cudnn.enabled, cudnn.deterministic, cudnn.benchmark,
            cudnn.allow_tf32, matmul.allow_tf32,
            torch.get_float32_matmul_precision(),
            torch.are_deterministic_algorithms_enabled())


def key(stage: str, fn, params, inputs, static=()) -> tuple:
    """What decides the work `fn(params, *inputs, *static)` launches."""
    return (stage, fn,
            tuple((t.data_ptr(), t.shape, t.stride(), t.dtype)
                  for t in _leaves(params, [])),
            tuple((x.shape, x.dtype, x.device) for x in inputs),
            static, _flags())


class _Graph:
    """A captured stage: the graph, its input buffers and outputs, and the
    kernel launches it holds (`COUNTERS`' order)."""

    __slots__ = ("graph", "inputs", "outputs", "launches", "single")

    def __init__(self, graph, inputs, outputs, launches):
        self.graph, self.inputs, self.launches = graph, inputs, launches
        self.single = isinstance(outputs, torch.Tensor)
        self.outputs = (outputs,) if self.single else tuple(outputs)

    def replay(self, inputs):
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        # an operation of the function scope, which the profiler links
        # the graph's kernels to (a `record_function` range is a user's)
        with _RecordFunctionFast("graph_replay"):
            self.graph.replay()
        _advance(self.launches)
        outs = tuple(o.clone() for o in self.outputs)
        return outs[0] if self.single else outs


class StageGraphs:
    """The graphs of a process's stages (see the module's docstring)."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self._keys: collections.OrderedDict = collections.OrderedDict()
        self._stats: dict = {}
        self._pool = None
        self._streams: dict = {}

    # -- bookkeeping ----------------------------------------------------------

    def _count(self, stage: str, what: str, error: str | None = None):
        s = self._stats.setdefault(stage, {"eager": 0, "captures": 0,
                                           "replays": 0, "failed": 0})
        s[what] += 1
        if error is not None:
            s["error"] = error

    def stats(self) -> dict:
        """{stage: {"eager", "captures", "replays", "failed" (captures
        that failed), and "error" (the last failure's message) where one
        failed}}, counted since the last `reset`."""
        return {k: dict(v) for k, v in self._stats.items()}

    def reset(self) -> None:
        """Drop every graph and the counts."""
        if any(isinstance(v, _Graph) for v in self._keys.values()):
            self._drop()
        self._keys.clear()
        self._stats.clear()
        self._pool = None

    def _drop(self) -> None:
        """Before graphs are dropped: their last replays may run still."""
        torch.cuda.synchronize()

    def _remember(self, k, value) -> None:
        self._keys[k] = value
        self._keys.move_to_end(k)
        while len(self._keys) > self.capacity:
            _, old = self._keys.popitem(last=False)
            if isinstance(old, _Graph):
                self._drop()
                # the allocator frees a pool with its last graph: a
                # capture into its id would find it gone
                if not any(isinstance(v, _Graph)
                           for v in self._keys.values()):
                    self._pool = None

    # -- running --------------------------------------------------------------

    @staticmethod
    def engaged(inputs) -> bool:
        """Whether a graph can hold a stage on these inputs."""
        return (not torch.is_grad_enabled()
                and all(x.is_cuda for x in inputs)
                and not torch.cuda.is_current_stream_capturing())

    def run(self, stage: str, fn, params, *inputs, static=(),
            enabled: bool = True):
        """`fn(params, *inputs, *static)`, from a graph where one holds it;
        `static` must be hashable where `enabled`."""
        if not (inputs and enabled and self.engaged(inputs)):
            self._count(stage, "eager")
            return fn(params, *inputs, *static)
        k = key(stage, fn, params, inputs, static)
        entry = self._keys.get(k)
        if isinstance(entry, _Graph):
            self._keys.move_to_end(k)
            self._count(stage, "replays")
            return entry.replay(inputs)
        if entry is None:
            self._remember(k, _SEEN)
            self._count(stage, "eager")
            return self._warm(fn, params, inputs, static)
        self._keys.move_to_end(k)
        if entry is _FAILED:
            self._count(stage, "eager")
            return fn(params, *inputs, *static)
        try:
            graph = self._capture(fn, params, inputs, static)
        except RuntimeError as e:
            # a failed capture may leave its pool recording: later
            # captures take a pool of their own
            self._pool = None
            self._remember(k, _FAILED)
            self._count(stage, "failed", f"{type(e).__name__}: {e}"[:500])
            self._count(stage, "eager")
            return fn(params, *inputs, *static)
        self._remember(k, graph)
        self._count(stage, "captures")
        return graph.replay(inputs)

    def _stream(self, device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device=device)
        return self._streams[device]

    def _warm(self, fn, params, inputs, static):
        """`fn` eagerly on the capture stream: what a capture would first
        set up there (a library's workspace for that stream) is set up
        outside it. The caller's stream waits for the result."""
        main = torch.cuda.current_stream(inputs[0].device)
        side = self._stream(inputs[0].device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn(params, *inputs, *static)
        main.wait_stream(side)
        return out

    def _capture(self, fn, params, inputs, static) -> _Graph:
        """Capture `fn` on buffers that take the inputs' place; raises
        RuntimeError where the capture failed, with the launch counters as
        they were."""
        main = torch.cuda.current_stream(inputs[0].device)
        side = self._stream(inputs[0].device)
        buffers = [torch.empty_like(x) for x in inputs]
        for buf, x in zip(buffers, inputs):
            buf.copy_(x)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = _counters()
        failure = None
        side.wait_stream(main)
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=self._pool)
                try:
                    outputs = fn(params, *buffers, *static)
                except RuntimeError as e:
                    failure = e
                finally:
                    try:
                        graph.capture_end()
                    except RuntimeError as e:
                        failure = failure or e
        finally:
            launches = tuple(a - b for a, b in zip(_counters(), before))
            _advance(tuple(-n for n in launches))   # nothing ran
        main.wait_stream(side)
        if failure is not None:
            raise failure
        return _Graph(graph, buffers, outputs, launches)


_GRAPHS = StageGraphs()


def run(stage: str, fn, params, *inputs, static=(), enabled: bool = True):
    """`StageGraphs.run` on the process's graphs."""
    return _GRAPHS.run(stage, fn, params, *inputs, static=static,
                       enabled=enabled)


def stats() -> dict:
    """`StageGraphs.stats` of the process's graphs."""
    return _GRAPHS.stats()


def reset() -> None:
    """Drop the process's graphs and their counts."""
    _GRAPHS.reset()
