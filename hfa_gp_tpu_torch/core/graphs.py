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
kernels' launch counters (`core/kernels/counters.py`) advance at each
replay by the launches the graph holds.

The graphs share one memory pool; at most `capacity` keys are kept, the
least recently used dropped first. A replay is issued inside the caller's
profiler range, as an operation named "graph_replay" that the profiler
links the graph's kernels to.

Training takes a path of its own, `loss(kind, fn, params, *inputs,
static=...)`: `fn` returns a tensor of loss terms that autograd
differentiates, and its forward and its backward are two graphs in a
pool of their own. It follows the same policy (eager at a key's first
sight, on the capture's stream; captured at the second, replayed after;
eager for good where a capture failed) where a graph can hold the step:
autograd recording, the inputs on the card, no capture under way, no
hook on a parameter (it would run inside the backward graph and again
where the gradient reaches the parameter), and a caller that does not
say otherwise (`enabled=False`: a mesh's collectives, a generator's
draws). A replay of the forward returns the terms copied out of the
graph, attached to autograd through a function whose backward replays
the backward graph, also as "graph_replay", inside whatever range
autograd's engine runs it in. The gradients reach the parameters'
`.grad` as autograd's accumulation takes them: where a `.grad` was None
it holds the backward graph's own output, which the next replay of that
key overwrites, so a caller clears the gradients (`set_to_none=True`)
before each step. A replay of the forward first waits until the card
has run the last one, so that the host runs at most a step ahead. The
key is the inference key, and whether each leaf requires a gradient;
`stats` counts the training path by `kind`.
"""

from __future__ import annotations

import collections

import torch
from torch import nn
from torch._C._profiler import _RecordFunctionFast

from .kernels import counters

# the launch counters a replay advances, as (module, attribute)
COUNTERS = tuple(counters.COUNTERS.values())

CAPACITY = 32
# a training key's graphs hold a step's activations in their pool
# (gigabytes at the avatars' widths): one key at a time, so that a state
# left behind does not pin a pool
TRAIN_CAPACITY = 1
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


class _Graphs:
    """What both paths keep: the counts by stage or kind, the keys in the
    order of their last use (at most `capacity`), one memory pool for
    their graphs and a capture stream a device."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._keys: collections.OrderedDict = collections.OrderedDict()
        self._stats: dict = {}
        self._pool = None
        self._streams: dict = {}

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

    def release(self) -> None:
        """Drop every graph and the keys seen, keeping the counts."""
        if any(not isinstance(v, str) for v in self._keys.values()):
            self._drop()
        self._keys.clear()
        self._pool = None

    def reset(self) -> None:
        """Drop every graph and the counts."""
        self.release()
        self._stats.clear()

    def _drop(self) -> None:
        """Before graphs are dropped: their last replays may run still."""
        torch.cuda.synchronize()

    def _remember(self, k, value) -> None:
        self._keys[k] = value
        self._keys.move_to_end(k)
        while len(self._keys) > self.capacity:
            _, old = self._keys.popitem(last=False)
            if not isinstance(old, str):
                self._drop()
                # the allocator frees a pool with its last graph: a
                # capture into its id would find it gone
                if all(isinstance(v, str) for v in self._keys.values()):
                    self._pool = None

    def _failed(self, k, stage: str, e: RuntimeError) -> None:
        # a failed capture may leave its pool recording: later captures
        # take a pool of their own
        self._pool = None
        self._remember(k, _FAILED)
        self._count(stage, "failed", f"{type(e).__name__}: {e}"[:500])
        self._count(stage, "eager")

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


class StageGraphs(_Graphs):
    """The graphs of a process's stages (see the module's docstring)."""

    def __init__(self, capacity: int = CAPACITY):
        super().__init__(capacity)

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
            self._failed(k, stage, e)
            return fn(params, *inputs, *static)
        self._remember(k, graph)
        self._count(stage, "captures")
        return graph.replay(inputs)

    def _capture(self, fn, params, inputs, static) -> _Graph:
        """Capture `fn` on buffers that take the inputs' place; raises
        RuntimeError where the capture failed, with the launch counters as
        they were."""
        device = inputs[0].device
        main = torch.cuda.current_stream(device)
        side = self._stream(device)
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


# -- training -----------------------------------------------------------------


def train_key(kind: str, fn, params, inputs, static=()) -> tuple:
    """`key` of a training loss, and which of its leaves want a gradient
    (the backward graph computes theirs alone)."""
    return key(kind, fn, params, inputs, static) \
        + (tuple(t.requires_grad for t in _leaves(params, [])),)


class _TrainGraph:
    """A captured loss: its forward and backward graphs, the forward's
    input buffers and terms, the backward's cotangent buffer and
    gradients (None for a leaf the loss does not reach), the kernel
    launches of each graph (`COUNTERS`' order), and an event recorded
    after each replay of the forward (None: no wait)."""

    __slots__ = ("forward", "backward", "inputs", "terms", "cotangent",
                 "grads", "launches", "done")

    def __init__(self, forward, backward, inputs, terms, cotangent, grads,
                 launches, done=None):
        self.forward, self.backward = forward, backward
        self.inputs, self.terms, self.cotangent = inputs, terms, cotangent
        self.grads, self.launches, self.done = grads, launches, done

    def run_forward(self, inputs) -> torch.Tensor:
        # the host waits until the card has run the last replay of the
        # forward, so that it stays at most a step ahead of the card
        # (which still has that step's backward and optimizer to run)
        # instead of filling CUDA's queue of pending launches and blocking
        # in whichever launch finds it full; a profiler ties a launch
        # blocked so to the block ("Command Buffer Full"), not to the
        # operation that issued it
        if self.done is not None:
            self.done.synchronize()
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        with _RecordFunctionFast("graph_replay"):
            self.forward.replay()
        if self.done is not None:
            self.done.record()
        _advance(self.launches[0])
        return self.terms.clone()

    def run_backward(self, cotangent) -> tuple:
        self.cotangent.copy_(cotangent)
        with _RecordFunctionFast("graph_replay"):
            self.backward.replay()
        _advance(self.launches[1])
        # detached, so that autograd's accumulation takes each as the
        # leaf's `.grad` where that was None instead of copying it
        return tuple(None if g is None else g.detach() for g in self.grads)


class _Replay(torch.autograd.Function):
    """A replay of the forward graph, whose gradient replays the backward
    graph; differentiable in the leaves that want a gradient."""

    @staticmethod
    def forward(ctx, graph, inputs, *wanted):
        ctx.graph = graph
        return graph.run_forward(inputs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, cotangent):
        return (None, None, *ctx.graph.run_backward(cotangent))


class TrainGraphs(_Graphs):
    """The graphs of a process's training losses (see the module's
    docstring)."""

    def __init__(self, capacity: int = TRAIN_CAPACITY):
        super().__init__(capacity)

    @staticmethod
    def _on_card(inputs) -> bool:
        return all(x.is_cuda for x in inputs)

    def engaged(self, inputs, leaves) -> bool:
        """Whether a graph can hold a loss and its backward on these
        inputs and parameters."""
        return (torch.is_grad_enabled()
                and self._on_card(inputs)
                and not any(t._backward_hooks for t in leaves)
                and not torch.cuda.is_current_stream_capturing())

    def loss(self, kind: str, fn, params, *inputs, static=(),
             enabled: bool = True) -> torch.Tensor:
        """`fn(params, *inputs, *static)`, a tensor of loss terms, from the
        graphs where they hold it; `static` must be hashable where
        `enabled`."""
        leaves = _leaves(params, [])
        if not (inputs and enabled and self.engaged(inputs, leaves)):
            self._count(kind, "eager")
            return fn(params, *inputs, *static)
        k = train_key(kind, fn, params, inputs, static)
        entry = self._keys.get(k)
        wanted = [t for t in leaves if t.requires_grad]
        if isinstance(entry, _TrainGraph):
            self._keys.move_to_end(k)
            self._count(kind, "replays")
            return _Replay.apply(entry, inputs, *wanted)
        if entry is None:
            self._remember(k, _SEEN)
            self._count(kind, "eager")
            # its backward runs where the forward ran: on the capture
            # stream, in autograd's threads
            return self._warm(fn, params, inputs, static)
        self._keys.move_to_end(k)
        if entry is _FAILED:
            self._count(kind, "eager")
            return fn(params, *inputs, *static)
        try:
            graph = self._capture(fn, params, wanted, inputs, static)
        except RuntimeError as e:
            self._failed(k, kind, e)
            return fn(params, *inputs, *static)
        self._remember(k, graph)
        self._count(kind, "captures")
        return _Replay.apply(graph, inputs, *wanted)

    def _record(self, graph, thunk, device):
        graph.capture_begin(pool=self._pool)
        try:
            return thunk()
        finally:
            try:
                graph.capture_end()
            except RuntimeError:
                # a capture whose end failed leaves the allocator routing
                # the stream's allocations to its pool, and while it does
                # the allocator frees none of its cache when an
                # allocation runs short: end that
                torch._C._cuda_endAllocateToPool(device.index, self._pool)
                raise

    def _capture(self, fn, params, wanted, inputs, static) -> _TrainGraph:
        """Capture `fn` on buffers that take the inputs' place, then the
        gradients of its terms in `wanted` under a cotangent buffer, into
        one pool; raises RuntimeError where either capture failed, with
        the launch counters as they were."""
        device = inputs[0].device
        main = torch.cuda.current_stream(device)
        side = self._stream(device)
        buffers = [torch.empty_like(x) for x in inputs]
        for buf, x in zip(buffers, inputs):
            buf.copy_(x)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        forward, backward = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        before = middle = _counters()
        side.wait_stream(main)
        try:
            with torch.cuda.stream(side):
                terms = self._record(
                    forward, lambda: fn(params, *buffers, *static), device)
                middle = _counters()
                cotangent = torch.empty_like(terms)
                grads = self._record(backward, lambda: torch.autograd.grad(
                    terms, wanted, cotangent, allow_unused=True), device)
        finally:
            after = _counters()
            _advance(tuple(b - a for a, b in zip(after, before)))  # none ran
            main.wait_stream(side)
        launches = (tuple(m - b for m, b in zip(middle, before)),
                    tuple(a - m for a, m in zip(after, middle)))
        # detached: the captured autograd graph holds the parameters
        return _TrainGraph(forward, backward, buffers, terms.detach(),
                           cotangent, grads, launches, torch.cuda.Event())


_GRAPHS = StageGraphs()
_TRAIN = TrainGraphs()


def run(stage: str, fn, params, *inputs, static=(), enabled: bool = True):
    """`StageGraphs.run` on the process's graphs."""
    return _GRAPHS.run(stage, fn, params, *inputs, static=static,
                       enabled=enabled)


def loss(kind: str, fn, params, *inputs, static=(), enabled: bool = True):
    """`TrainGraphs.loss` on the process's training graphs."""
    return _TRAIN.loss(kind, fn, params, *inputs, static=static,
                       enabled=enabled)


def stats() -> dict:
    """`StageGraphs.stats` of the process's stages and `TrainGraphs.stats`
    of its training losses, in one dict."""
    return {**_GRAPHS.stats(), **_TRAIN.stats()}


def release_training() -> None:
    """Drop the process's training graphs and the pool that holds their
    step's activations, keeping their counts: for a trainer that is done."""
    _TRAIN.release()


def reset() -> None:
    """Drop the process's graphs and their counts."""
    _GRAPHS.reset()
    _TRAIN.reset()
