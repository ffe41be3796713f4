"""The port's inference stages and training losses as CUDA graphs
(`core/graphs.py`) and the host constants kept on the card
(`core/ops.fir_taps`, `ops.device_constant`).

On the CPU: the cached FIR taps give the NumPy-built taps' outputs bit
for bit at every (taps, gain, up/down) the configurations use; the graph
helper runs eagerly and counts it; its keys; its bound, with a stand-in
for the card's graphs that replays the stage on the CPU; the training
path's keys, its eager routes, and eager → capture → replay through
`train.rgb.train_step`, with a stand-in that replays the loss and its
gradients on the CPU. Marked `gpu` (card only): replayed units against
eager ones under `cudnn.deterministic`, equal or within `CAPTURE_RTOL`;
the launch counters; parameters replaced and changed in place; a one-off
partial batch; a capture that fails; peak memory. The training graphs'
card tests are `tests/test_torch_train_graphs.py`.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hfa_gp_tpu_torch.core import graphs, ops
from hfa_gp_tpu_torch.core.kernels import raymarch, triplane
from hfa_gp_tpu_torch.utils.convert import ParamTree

torch.set_num_threads(1)


# -- the FIR taps -------------------------------------------------------------


def _upfirdn2d_numpy_taps(x, kernel, *, up=1, down=1, pad=(0, 0), gain=1.0):
    """`ops.upfirdn2d` as it was before its taps were kept on the device:
    the taps built in NumPy and copied at every call."""
    kernel = np.asarray(kernel, np.float32)
    if kernel.ndim == 1:
        kernel = ops.make_fir_kernel(kernel)
    kh, kw = kernel.shape
    b, c, h, w = x.shape
    if up > 1:
        x = x.reshape(b, c, h, 1, w, 1)
        x = F.pad(x, (0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(b, c, h * up, w * up)
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    k = torch.as_tensor(np.ascontiguousarray(kernel[::-1, ::-1]) * gain,
                        dtype=x.dtype, device=x.device)
    return F.conv2d(x, k[None, None].expand(c, 1, kh, kw), stride=down,
                    groups=c)


FIR = (1, 3, 3, 1)      # `fir` of both benchmark configurations, the encoder's


# (name, call of the cached route, the same call on the NumPy-built taps):
# the encoder's blurs before its 3x3 and 1x1 stride-2 convs, the modulated
# conv's FIR after its transposed conv (a 2-D kernel, gain 4), the torgb
# skip's upsample2d, and downsample2d
CASES = {
    "blur_3x3": (lambda x: ops.blur(x, ops.make_fir_kernel(FIR), pad=(2, 2)),
                 lambda x: _upfirdn2d_numpy_taps(
                     x, ops.make_fir_kernel(FIR), pad=(2, 2))),
    "blur_1x1": (lambda x: ops.blur(x, ops.make_fir_kernel(FIR), pad=(1, 1)),
                 lambda x: _upfirdn2d_numpy_taps(
                     x, ops.make_fir_kernel(FIR), pad=(1, 1))),
    "modconv_up": (lambda x: ops.upfirdn2d(x, ops.make_fir_kernel(FIR),
                                           pad=(1, 1), gain=4.0),
                   lambda x: _upfirdn2d_numpy_taps(
                       x, ops.make_fir_kernel(FIR), pad=(1, 1), gain=4.0)),
    "upsample2d": (lambda x: ops.upsample2d(x, ops.make_fir_kernel(FIR)),
                   lambda x: _upfirdn2d_numpy_taps(
                       x, ops.make_fir_kernel(FIR), up=2, pad=(2, 1),
                       gain=4.0)),
    "upsample2d_1d": (lambda x: ops.upsample2d(x, FIR),
                      lambda x: _upfirdn2d_numpy_taps(x, FIR, up=2,
                                                      pad=(2, 1), gain=4.0)),
    "downsample2d": (lambda x: ops.downsample2d(x, ops.make_fir_kernel(FIR)),
                     lambda x: _upfirdn2d_numpy_taps(
                         x, ops.make_fir_kernel(FIR), down=2, pad=(1, 1))),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kept_fir_taps_give_the_numpy_built_taps_outputs(case, dtype):
    cached, built = CASES[case]
    x = torch.randn((2, 5, 16, 16), generator=torch.Generator()
                    .manual_seed(3)).to(dtype)
    for _ in range(2):                        # built, then from the cache
        got = cached(x)
        assert got.dtype == dtype
        assert torch.equal(got, built(x))


def test_fir_taps_are_kept_once_per_taps_gain_dtype_device():
    k = ops.make_fir_kernel(FIR)
    a = ops.fir_taps(k, 4.0, torch.float32, torch.device("cpu"))
    assert ops.fir_taps(k.copy(), 4.0, torch.float32, "cpu") is a
    assert ops.fir_taps(k, 1.0, torch.float32, "cpu") is not a
    assert ops.fir_taps(k, 4.0, torch.bfloat16, "cpu") is not a
    assert torch.equal(ops.fir_taps(FIR, 4.0, torch.float32, "cpu"),
                       a)                         # 1-D taps: normalized
    np.testing.assert_array_equal(a.numpy(), k[::-1, ::-1] * 4.0)


def test_kept_constants_serve_autograd_after_inference_mode():
    """A constant kept first under inference mode is a normal tensor, so
    a later training forward may save it for its backward."""
    x = torch.randn((1, 2, 8, 8))
    with torch.inference_mode():
        ops.upsample2d(x, (1, 2, 2, 1))
    xg = x.clone().requires_grad_(True)
    ops.upsample2d(xg, (1, 2, 2, 1)).sum().backward()
    assert xg.grad is not None
    inv = ops.device_constant(triplane.PLANE_INV, torch.float32, "cpu")
    assert not inv.is_inference()
    np.testing.assert_array_equal(inv.numpy(), triplane.PLANE_INV)


# -- the graph helper on the CPU ----------------------------------------------


def _stage(params, x, scale):
    return (x @ params["w"]) * scale + params["b"]


def _other_stage(params, x, scale):
    return (x @ params["w"]) * scale


def _tree(seed=0, n=4):
    g = torch.Generator().manual_seed(seed)
    return ParamTree({"w": torch.randn((n, n), generator=g),
                      "b": torch.randn((n,), generator=g)})


def test_graph_helper_runs_eagerly_on_the_cpu_and_counts_it():
    sg = graphs.StageGraphs()
    p, x = _tree(), torch.randn((3, 4))
    for _ in range(3):
        assert torch.equal(sg.run("s", _stage, p, x, static=(2.0,)),
                           _stage(p, x, 2.0))
    assert sg.stats() == {"s": {"eager": 3, "captures": 0, "replays": 0,
                                "failed": 0}}
    assert not sg._keys                       # nothing kept off the card
    graphs.run("s", _stage, p, x, static=(2.0,))      # the process's own
    assert graphs.stats()["s"]["eager"] >= 1


def test_graph_keys():
    p, x = _tree(), torch.randn((3, 4))
    k = graphs.key("s", _stage, p, (x,), (2.0,))
    assert graphs.key("s", _stage, p, (torch.randn((3, 4)),), (2.0,)) == k
    assert graphs.key("s", _stage, p, (x.t().contiguous().t(),),
                      (2.0,)) == k                # the input's layout: no
    with torch.no_grad():
        p["w"].mul_(2.0)                          # in place: seen by a graph
    assert graphs.key("s", _stage, p, (x,), (2.0,)) == k
    others = [
        graphs.key("s", _stage, p, (torch.randn((5, 4)),), (2.0,)),
        graphs.key("s", _stage, p, (x.double(),), (2.0,)),
        graphs.key("s", _stage, _tree(), (x,), (2.0,)),       # new params
        graphs.key("s", _other_stage, p, (x,), (2.0,)),      # new function
        graphs.key("t", _stage, p, (x,), (2.0,)),
        graphs.key("s", _stage, p, (x,), (3.0,)),
    ]
    with torch.no_grad():
        others.append(graphs.key("s", _stage, p, (x,), (2.0,)))  # grad off
    p.register_parameter("b", torch.nn.Parameter(torch.zeros(4),
                                                 requires_grad=False))
    others.append(graphs.key("s", _stage, p, (x,), (2.0,)))  # a leaf swapped
    assert len({k, *others}) == len(others) + 1


class _CpuGraph:
    """Stands in for `torch.cuda.CUDAGraph` on the CPU: a replay runs the
    stage again on the buffers and writes its outputs in place."""

    def __init__(self, fn, params, buffers, static, outputs):
        self.args = fn, params, buffers, static
        self.outputs = outputs
        self.replays = 0

    def replay(self):
        fn, params, buffers, static = self.args
        self.outputs.copy_(fn(params, *buffers, *static))
        self.replays += 1


class _CpuStageGraphs(graphs.StageGraphs):
    """`StageGraphs` with the card's graphs stood in for, so that its keys,
    its counts and its bound run on the CPU."""

    def __init__(self, capacity):
        super().__init__(capacity)
        self.dropped = 0

    @staticmethod
    def engaged(inputs):
        return not torch.is_grad_enabled()

    def _warm(self, fn, params, inputs, static):
        return fn(params, *inputs, *static)

    def _capture(self, fn, params, inputs, static):
        buffers = [x.clone() for x in inputs]
        out = fn(params, *buffers, *static)
        return graphs._Graph(_CpuGraph(fn, params, buffers, static, out),
                             buffers, out, (1, 0, 2, 0))

    def _drop(self):
        self.dropped += 1


def test_graph_helper_captures_on_the_second_sighting_and_replays():
    sg = _CpuStageGraphs(capacity=8)
    p = _tree()
    xs = [torch.randn((3, 4)) for _ in range(4)]
    before = (triplane.LAUNCHES, raymarch.LAUNCHES)
    with torch.no_grad():
        outs = [sg.run("s", _stage, p, x, static=(2.0,)) for x in xs]
        for x, out in zip(xs, outs):
            assert torch.equal(out, _stage(p, x, 2.0))
        # the replays' outputs are copies, not the graph's own
        assert outs[2].data_ptr() != outs[3].data_ptr()
        p["w"].mul_(0.5)                          # seen by the next replay
        assert torch.equal(sg.run("s", _stage, p, xs[0], static=(2.0,)),
                           _stage(p, xs[0], 2.0))
    assert sg.stats()["s"] == {"eager": 1, "captures": 1, "replays": 3,
                               "failed": 0}
    # the replays advance the counters by the launches their graph holds
    assert (triplane.LAUNCHES - before[0],
            raymarch.LAUNCHES - before[1]) == (4, 8)
    triplane.LAUNCHES, raymarch.LAUNCHES = before


def test_graph_helper_keeps_its_bound():
    sg = _CpuStageGraphs(capacity=4)
    p = _tree()
    with torch.no_grad():
        for n in range(1, 9):                     # 8 shapes, each twice
            x = torch.randn((n, 4))
            sg.run("s", _stage, p, x, static=(2.0,))
            sg.run("s", _stage, p, x, static=(2.0,))
            assert len(sg._keys) <= 4
        assert sg.dropped == 4                    # the 4 oldest graphs
        x = torch.randn((8, 4))                   # the newest: still kept
        sg.run("s", _stage, p, x, static=(2.0,))
    assert sg.stats()["s"] == {"eager": 8, "captures": 8, "replays": 1,
                               "failed": 0}
    sg.reset()
    assert not sg._keys and not sg.stats()


# -- the training path on the CPU ---------------------------------------------


def _loss(params, x, scale):
    y = (x @ params["w"]) * scale + params["b"]
    return torch.stack((y.square().mean() + params["b"].sum(),
                        y.mean()))


def _trained_tree(seed=0, n=4):
    tree = _tree(seed, n)
    tree.requires_grad_(True)
    return tree


def test_training_keys_are_the_inference_keys_and_what_wants_a_gradient():
    p, x = _trained_tree(), torch.randn((3, 4))
    leaves = graphs._leaves(p, [])
    k = graphs.train_key("l", _loss, p, (x,), (2.0,))
    assert k == graphs.key("l", _loss, p, (x,), (2.0,)) + ((True, True),)
    # the inference key as it was: the stage, the function, each leaf's
    # address and layout, the inputs' shapes, the static, the modes
    assert graphs.key("l", _loss, p, (x,), (2.0,)) == (
        "l", _loss, tuple((t.data_ptr(), t.shape, t.stride(), t.dtype)
                          for t in leaves),
        ((x.shape, x.dtype, x.device),), (2.0,), graphs._flags())
    assert graphs.train_key("l", _loss, p, (torch.randn((3, 4)),),
                            (2.0,)) == k
    with torch.no_grad():
        p["w"].mul_(2.0)                          # Adam's update: in place
    assert graphs.train_key("l", _loss, p, (x,), (2.0,)) == k
    others = [
        graphs.train_key("l", _loss, p, (torch.randn((5, 4)),), (2.0,)),
        graphs.train_key("l", _loss, p, (x.double(),), (2.0,)),
        graphs.train_key("l", _loss, _trained_tree(), (x,),
                         (2.0,)),                # new params
        graphs.train_key("l", _stage, p, (x,), (2.0,)),
        graphs.train_key("m", _loss, p, (x,), (2.0,)),
        graphs.train_key("l", _loss, p, (x,), (3.0,)),
    ]
    with torch.no_grad():
        others.append(graphs.train_key("l", _loss, p, (x,), (2.0,)))
    p["b"].requires_grad_(False)                 # no gradient wanted
    others.append(graphs.train_key("l", _loss, p, (x,), (2.0,)))
    assert len({k, *others}) == len(others) + 1


class _CpuLossGraph:
    """Stands in for the forward graph on the CPU: a replay runs the loss
    again on the buffers, under autograd, and writes its terms in place."""

    def __init__(self, fn, params, buffers, static, terms):
        self.args = fn, params, buffers, static
        self.terms, self.live = terms, None

    def replay(self):
        fn, params, buffers, static = self.args
        with torch.enable_grad():
            self.live = fn(params, *buffers, *static)
        self.terms.copy_(self.live.detach())


class _CpuGradGraph:
    """Stands in for the backward graph: the gradients of the last forward
    replay's terms under the cotangent buffer, written in place."""

    def __init__(self, forward, wanted, cotangent, grads):
        self.forward, self.wanted = forward, wanted
        self.cotangent, self.grads = cotangent, grads

    def replay(self):
        got = torch.autograd.grad(self.forward.live, self.wanted,
                                  self.cotangent, allow_unused=True)
        for buf, g in zip(self.grads, got):
            if buf is not None:
                buf.copy_(g)
        self.forward.live = None


# the launches a stand-in's forward and backward "hold", in `COUNTERS`'
# order (triplane, triplane_bwd, raymarch, raymarch_bwd)
_FWD, _BWD = (1, 0, 2, 0), (0, 3, 0, 4)


class _CpuTrainGraphs(graphs.TrainGraphs):
    """`TrainGraphs` with the card's graphs stood in for: CPU inputs count
    as the card's, the capture runs the loss and its gradients once to
    lay out their buffers, and `fail` captures raise."""

    def __init__(self, capacity=graphs.TRAIN_CAPACITY, fail=0):
        super().__init__(capacity)
        self.fail, self.captured, self.dropped = fail, 0, 0

    @staticmethod
    def _on_card(inputs):
        return True

    def _warm(self, fn, params, inputs, static):
        return fn(params, *inputs, *static)

    def _capture(self, fn, params, wanted, inputs, static):
        self.captured += 1
        if self.fail:
            self.fail -= 1
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        buffers = [x.clone() for x in inputs]
        live = fn(params, *buffers, *static)
        grads = torch.autograd.grad(live, wanted, torch.ones_like(live),
                                    allow_unused=True)
        forward = _CpuLossGraph(fn, params, buffers, static,
                                live.detach().clone())
        cotangent = torch.empty_like(forward.terms)
        backward = _CpuGradGraph(forward, wanted, cotangent,
                                 [None if g is None else torch.empty_like(g)
                                  for g in grads])
        return graphs._TrainGraph(forward, backward, buffers, forward.terms,
                                  cotangent, backward.grads, (_FWD, _BWD))

    def _drop(self):
        self.dropped += 1


@pytest.fixture
def not_capturing(monkeypatch):
    """No capture under way (the CPU build cannot be asked)."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)


def _grads(p):
    return [None if t.grad is None else t.grad.clone() for t in
            graphs._leaves(p, [])]


def _step(tg, p, x, kind="l", **kw):
    """One loss and its backward, as a training step issues them →
    (terms, each leaf's gradient)."""
    for t in graphs._leaves(p, []):
        t.grad = None
    terms = tg.loss(kind, _loss, p, x, static=(2.0,), **kw)
    terms[0].backward()
    return terms, _grads(p)


def test_training_losses_run_eagerly_off_the_card_and_count_it():
    tg = graphs.TrainGraphs()
    p, x = _trained_tree(), torch.randn((3, 4))
    want = _loss(p, x, 2.0)
    for _ in range(3):
        terms, _ = _step(tg, p, x)
        assert torch.equal(terms, want)
    assert tg.stats() == {"l": {"eager": 3, "captures": 0, "replays": 0,
                                "failed": 0}}
    assert not tg._keys                       # nothing kept off the card


def test_training_graphs_capture_on_the_second_sighting_and_replay(
        not_capturing):
    tg = _CpuTrainGraphs()
    p = _trained_tree()
    xs = [torch.randn((3, 4)) for _ in range(4)]
    before = (triplane.LAUNCHES, triplane.LAUNCHES_BWD, raymarch.LAUNCHES,
              raymarch.LAUNCHES_BWD)
    outs = []
    for x in xs:
        terms, grads = _step(tg, p, x)
        want = _loss(p, x, 2.0)
        want_grads = torch.autograd.grad(want[0], [p["w"], p["b"]])
        assert torch.equal(terms, want.detach())
        assert terms.requires_grad
        for g, w in zip(grads, want_grads):
            assert torch.equal(g, w)
        outs.append(terms)
    # the replays' terms are copies of their own, not the graph's buffer
    assert len({t.data_ptr() for t in outs}) == 4
    for x, t in zip(xs, outs):
        assert torch.equal(t.detach(), _loss(p, x, 2.0).detach())
    assert tg.stats()["l"] == {"eager": 1, "captures": 1, "replays": 2,
                               "failed": 0}
    assert tg.captured == 1
    # each replay of either graph advances the counters by its launches
    after = (triplane.LAUNCHES, triplane.LAUNCHES_BWD, raymarch.LAUNCHES,
             raymarch.LAUNCHES_BWD)
    assert tuple(a - b for a, b in zip(after, before)) == (3, 9, 6, 12)
    # parameters changed in place: the same graphs read them anew
    with torch.no_grad():
        p["w"].mul_(0.5)
    terms, _ = _step(tg, p, xs[0])
    assert torch.equal(terms, _loss(p, xs[0], 2.0).detach())
    assert tg.stats()["l"]["replays"] == 3
    # new parameters: a new key, first eager
    _step(tg, _trained_tree(seed=1), xs[0])
    assert tg.stats()["l"]["eager"] == 2
    (triplane.LAUNCHES, triplane.LAUNCHES_BWD, raymarch.LAUNCHES,
     raymarch.LAUNCHES_BWD) = before


@pytest.mark.parametrize("route", ["grad_off", "disabled", "capturing",
                                   "hooked"])
def test_training_graphs_stay_off_where_they_cannot_hold_the_step(
        route, monkeypatch, not_capturing):
    """Autograd off; a caller that says so (a mesh's collectives, a render
    generator's draws); a capture already under way; a hook on a leaf."""
    tg = _CpuTrainGraphs()
    p, x = _trained_tree(), torch.randn((3, 4))
    kw = {}
    if route == "disabled":
        kw["enabled"] = False
    elif route == "capturing":
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
    elif route == "hooked":
        p["w"].register_hook(lambda g: g * 4)
    for _ in range(3):
        if route == "grad_off":
            with torch.no_grad():
                terms = tg.loss("l", _loss, p, x, static=(2.0,))
            assert not terms.requires_grad
        else:
            terms, grads = _step(tg, p, x, **kw)
            want = torch.autograd.grad(_loss(p, x, 2.0)[0], p["w"])[0]
            assert torch.equal(grads[0], want)
        assert torch.equal(terms.detach(), _loss(p, x, 2.0).detach())
    assert tg.stats()["l"] == {"eager": 3, "captures": 0, "replays": 0,
                               "failed": 0}
    assert tg.captured == 0 and not tg._keys


def test_a_loss_whose_capture_fails_runs_eagerly_from_then_on(
        not_capturing):
    tg = _CpuTrainGraphs(fail=1)
    p, x = _trained_tree(), torch.randn((3, 4))
    for _ in range(4):
        terms, grads = _step(tg, p, x)
        assert torch.equal(terms, _loss(p, x, 2.0).detach())
        assert torch.equal(grads[1], torch.autograd.grad(
            _loss(p, x, 2.0)[0], p["b"])[0])
    st = tg.stats()["l"]
    assert (st["eager"], st["captures"], st["replays"], st["failed"]) \
        == (4, 0, 0, 1)
    assert "not permitted" in st["error"]
    assert tg.captured == 1                   # never tried again


def test_training_graphs_keep_their_own_bound_and_leave_the_stages_be(
        monkeypatch, not_capturing):
    """The process's stats hold both paths; the stages' counts and keys
    are the inference path's alone."""
    stages, train = _CpuStageGraphs(capacity=8), _CpuTrainGraphs(capacity=2)
    monkeypatch.setattr(graphs, "_GRAPHS", stages)
    monkeypatch.setattr(graphs, "_TRAIN", train)
    p, x = _tree(), torch.randn((3, 4))
    tp = _trained_tree()
    for n in (3, 4, 5, 3):                     # three shapes, the first twice
        xn = torch.randn((n, 4))
        for _ in range(2):
            _step(train, tp, xn)
        with torch.no_grad():
            graphs.run("s", _stage, p, x, static=(2.0,))
    assert len(train._keys) <= 2 and train.dropped == 2
    assert len(stages._keys) == 1
    assert graphs.stats() == {
        "s": {"eager": 1, "captures": 1, "replays": 2, "failed": 0},
        "l": {"eager": 4, "captures": 4, "replays": 0, "failed": 0}}
    graphs.reset()
    assert not graphs.stats() and not train._keys and not stages._keys


class _Event:
    """Stands in for the card's event: a record and a wait, logged."""

    def __init__(self, log):
        self.log = log

    def record(self):
        self.log.append("record")

    def synchronize(self):
        self.log.append("wait")


def test_a_replayed_forward_waits_for_the_last_backward(not_capturing):
    """The host runs at most a step ahead of the card: each replay of the
    forward first waits for the event recorded after the last one."""
    log = []

    class Logged(_CpuTrainGraphs):
        def _capture(self, *args):
            graph = super()._capture(*args)
            for name, g in (("forward", graph.forward),
                            ("backward", graph.backward)):
                replay = g.replay
                g.replay = (lambda name=name, replay=replay:
                            (log.append(name), replay()))
            graph.done = _Event(log)
            return graph

    tg = Logged()
    p, x = _trained_tree(), torch.randn((3, 4))
    for _ in range(4):                        # eager, captured, replayed ×2
        terms, _ = _step(tg, p, x)
        assert torch.equal(terms.detach(), _loss(p, x, 2.0).detach())
    assert log == ["wait", "forward", "record", "backward"] * 3


def test_released_training_graphs_keep_their_counts_and_the_stages(
        monkeypatch, not_capturing):
    """`release_training` drops the training graphs and their keys (a
    trainer that is done hands back the pool of its step's activations);
    the counts stay, and the stages' graphs are left as they are."""
    stages, train = _CpuStageGraphs(capacity=8), _CpuTrainGraphs()
    monkeypatch.setattr(graphs, "_GRAPHS", stages)
    monkeypatch.setattr(graphs, "_TRAIN", train)
    p, x, tp = _tree(), torch.randn((3, 4)), _trained_tree()
    for _ in range(3):
        _step(train, tp, x)
        with torch.no_grad():
            graphs.run("s", _stage, p, x, static=(2.0,))
    before = graphs.stats()
    graphs.release_training()
    assert not train._keys and train._pool is None and train.dropped == 1
    assert graphs.stats() == before and len(stages._keys) == 1
    _step(train, tp, x)                       # a key seen anew: eager
    assert graphs.stats()["l"]["eager"] == before["l"]["eager"] + 1


# the tiny avatar of `tests/test_torch_observability.py`
def _tiny_cfg():
    from hfa_gp_tpu_torch.models.avatar import heads
    from hfa_gp_tpu_torch.models.eg3d import generator as gen
    from hfa_gp_tpu_torch.models.eg3d import networks as nets
    from hfa_gp_tpu_torch.models.eg3d import renderer as rnd
    return heads.AvatarConfig(size=32, dim_shape=4, eg3d=gen.EG3DConfig(
        backbone=nets.BackboneConfig(img_resolution=16, img_channels=24,
                                     channel_base=256, channel_max=32),
        sr=nets.SRConfig(input_resolution=8, output_resolution=32,
                         in_channels=8, block_channels=(16, 8)),
        render=rnd.RenderConfig(depth_resolution=4,
                                depth_resolution_importance=4,
                                neural_rendering_resolution=8,
                                decoder_hidden=16, decoder_output_dim=8,
                                sampler_depth_window=2)))


def _tiny_fit(cfg, steps, mesh=None):
    """`steps` RGB training steps from one seeded state on batches of 2 →
    [(loss terms, each leaf's gradient, each leaf's value)] a step."""
    from hfa_gp_tpu_torch.core import camera as cam
    from hfa_gp_tpu_torch.models import lpips
    from hfa_gp_tpu_torch.models.avatar import heads
    from hfa_gp_tpu_torch.train import rgb
    from hfa_gp_tpu_torch.train.state import init_state
    g = torch.Generator().manual_seed(0)
    state = init_state(heads.init_avatar_rgb(g, cfg))
    lp = ParamTree(lpips.init_lpips(g))
    batches = [(torch.rand((2, cfg.size, cfg.size, 3), generator=g) * 2 - 1,
                cam.flip_yz_label(cam.sample_camera_label(g, n=2)))
               for _ in range(steps)]
    out = []
    for image, label in batches:
        m = rgb.train_step(state, lp, cfg, image, label, 0, mesh=mesh)
        leaves = list(state.params.parameters())
        out.append(((m["loss"], m["l2_loss"], m["lpips_loss"]),
                    [None if t.grad is None else t.grad.clone()
                     for t in leaves],
                    [t.detach().clone() for t in leaves]))
    return out


def test_replayed_fitting_steps_match_eager_ones(monkeypatch, not_capturing):
    """`train.rgb.train_step` through the training path (eager, captured,
    replayed, replayed) against four eager steps from the same state:
    the same losses, gradients and parameters, and each step's returned
    losses its own tensors."""
    cfg = _tiny_cfg()
    want = _tiny_fit(cfg, 4)                  # on the CPU: eager
    train = _CpuTrainGraphs()
    monkeypatch.setattr(graphs, "_TRAIN", train)
    got = _tiny_fit(cfg, 4)
    assert graphs.stats()["rgb_loss"] == {"eager": 1, "captures": 1,
                                          "replays": 2, "failed": 0}
    for (gl, gg, gv), (wl, wg, wv) in zip(got, want):
        for a, b in zip(gl, wl):
            assert torch.equal(a, b)
        for a, b in zip(gg, wg):
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b)
        for a, b in zip(gv, wv):
            assert torch.equal(a, b)
    losses = [l for step in got for l in step[0]]
    assert len({l.data_ptr() for l in losses}) == len(losses)
    assert len({float(step[0][0]) for step in got}) == 4


@pytest.mark.parametrize("n_data", [1, 2])
def test_the_fitting_step_is_graphed_on_one_rank_alone(
        n_data, monkeypatch, not_capturing):
    """A mesh of one rank has no collectives (the CLIs pass one); a data
    axis keeps the step eager."""
    from hfa_gp_tpu_torch.parallel import mesh as mesh_mod
    monkeypatch.setattr(graphs, "_TRAIN", _CpuTrainGraphs())
    # no process group here: the join over the data axis stands aside
    monkeypatch.setattr(mesh_mod, "data_parallel_step",
                        lambda params, metrics, mesh: metrics)
    _tiny_fit(_tiny_cfg(), 3, mesh=mesh_mod.Mesh(n_data=n_data))
    st = graphs.stats()["rgb_loss"]
    assert (st["eager"], st["captures"], st["replays"]) \
        == ((1, 1, 1) if n_data == 1 else (3, 0, 0))


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda(monkeypatch):
    """The card, with TF32 off as the CLIs set it and cuDNN deterministic,
    and the process's graphs dropped before and after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    graphs.reset()
    yield torch.device("cuda")
    graphs.reset()


def _rgb(device, seed=0):
    from hfa_gp_tpu_torch.models.avatar import heads
    cfg = heads.AvatarConfig()
    return cfg, heads.init_avatar_rgb(torch.Generator().manual_seed(seed),
                                      cfg, device)


def _rgb_inputs(cfg, b, device, seed):
    from hfa_gp_tpu_torch.core import camera as cam
    g = torch.Generator().manual_seed(seed)
    image = torch.rand((b, cfg.size, cfg.size, 3), generator=g) * 2 - 1
    label = cam.flip_yz_label(cam.sample_camera_label(g, n=b))
    return image.to(device), label.to(device)


def _reenact(params, cfg, image, label, graphed=True):
    """One unit: replayed where the graphs hold it, or eager (autograd
    on, with nothing that requires a gradient, keeps the graphs off)."""
    from hfa_gp_tpu_torch.cli.run_recon_video_rgb import reenact
    mode = torch.inference_mode() if graphed else torch.enable_grad()
    with mode:
        return reenact(params, cfg, image, label)


# Under capture cuDNN may run a convolution with another of its
# deterministic engines than eagerly (its choice follows the state of
# the allocator): at batch 8 the grouped transposed convolution of
# `ops.modulated_conv2d` (up=2: (1, 4096, 32, 32) by (4096, 512, 3, 3),
# groups 8) is the first operation to differ, by 7.4e-7 relative, and the
# frames differ by 4.2-5.5e-7 (the eager path's own spread without
# `cudnn.deterministic`: 4.1-4.3e-7); at batch 1 and 2 they came out
# equal bit for bit in most runs.
CAPTURE_RTOL = 2e-6


def _assert_same(got, want):
    if not torch.equal(got, want):
        rel = float((got - want).norm() / want.norm())
        assert rel <= CAPTURE_RTOL, rel


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2, 8])
def test_replayed_reenact_matches_eager(cuda, b):
    cfg, params = _rgb(cuda)
    batches = [_rgb_inputs(cfg, b, cuda, s) for s in range(3)]
    want = [_reenact(params, cfg, *x, graphed=False) for x in batches]
    assert all(bool(torch.isfinite(w).all()) for w in want)
    for i in (0, 1, 2, 0, 1):
        _assert_same(_reenact(params, cfg, *batches[i]), want[i])
    st = graphs.stats()
    for stage in ("encoder", "subspace", "rays", "backbone", "render",
                  "superres"):
        assert st[stage]["captures"] == 1, (stage, st[stage])
        assert st[stage]["replays"] == 3, (stage, st[stage])


@pytest.mark.gpu
def test_replayed_audio_sample_matches_eager(cuda):
    from hfa_gp_tpu_torch.core import camera as cam
    from hfa_gp_tpu_torch.models.avatar import heads
    from hfa_gp_tpu_torch.train import audio
    cfg = heads.AvatarConfig()
    params = audio.init_audio_params(torch.Generator().manual_seed(1), cfg,
                                     cuda)
    g = torch.Generator().manual_seed(2)
    batches = [(torch.randn((8, cfg.smo_size, 16, 29), generator=g).to(cuda),
                cam.flip_yz_label(cam.sample_camera_label(g, n=8)).to(cuda))
               for _ in range(2)]
    want = []
    for w, lab in batches:
        with torch.enable_grad():
            codes = audio.encode_audio(params, cfg, w, True)
            want.append(heads.audio_forward(params["model"], cfg, codes,
                                            lab))
    for i in (0, 1, 0, 1):
        _assert_same(audio.sample(params, cfg, *batches[i], smooth=True),
                     want[i])
    st = graphs.stats()
    for stage in ("audio_encoder", "subspace", "rays", "backbone", "render",
                  "superres"):
        assert st[stage]["replays"] == 2, st


@pytest.mark.gpu
def test_replays_advance_the_launch_counters_as_eager_units(cuda):
    cfg, params = _rgb(cuda)
    x = _rgb_inputs(cfg, 2, cuda, 0)

    def launches(graphed):
        before = (triplane.LAUNCHES, raymarch.LAUNCHES)
        _reenact(params, cfg, *x, graphed=graphed)
        return triplane.LAUNCHES - before[0], raymarch.LAUNCHES - before[1]

    eager = launches(False)
    assert eager == (2, 2)
    assert [launches(True) for _ in range(4)] == [eager] * 4
    assert graphs.stats()["render"]["replays"] == 2, graphs.stats()


@pytest.mark.gpu
def test_replays_see_parameters_replaced_and_changed_in_place(cuda):
    cfg, params = _rgb(cuda)
    x = _rgb_inputs(cfg, 2, cuda, 0)
    for _ in range(3):
        _reenact(params, cfg, *x)
    # other parameters: new keys, so a first eager run, and new frames
    _, other = _rgb(cuda, seed=5)
    want = _reenact(other, cfg, *x, graphed=False)
    for _ in range(3):
        _assert_same(_reenact(other, cfg, *x), want)
    # the same parameters changed in place: the graphs read them anew
    with torch.no_grad():
        for name in ("bases", "delta"):
            other["subspace"][name].mul_(1.25)
        for p in other["generator"]["superresolution"].parameters():
            p.mul_(0.9)
    want = _reenact(other, cfg, *x, graphed=False)
    replays = graphs.stats()["superres"]["replays"]
    _assert_same(_reenact(other, cfg, *x), want)
    assert graphs.stats()["superres"]["replays"] == replays + 1, \
        graphs.stats()


@pytest.mark.gpu
def test_a_one_off_partial_batch_runs_eagerly(cuda):
    cfg, params = _rgb(cuda)
    for _ in range(3):
        _reenact(params, cfg, *_rgb_inputs(cfg, 8, cuda, 0))
    x = _rgb_inputs(cfg, 5, cuda, 1)
    want = _reenact(params, cfg, *x, graphed=False)
    before = graphs.stats()
    _assert_same(_reenact(params, cfg, *x), want)
    after = graphs.stats()
    for stage, s in after.items():
        assert s["eager"] == before[stage]["eager"] + 1, stage
        assert s["captures"] == before[stage]["captures"], stage


@pytest.mark.gpu
def test_a_stage_whose_capture_fails_runs_eagerly(cuda):
    def synchronising(params, x):
        return x * float(x.sum())                # a copy to the host

    x = torch.arange(4.0, device=cuda)
    with torch.no_grad():
        outs = [graphs.run("sync", synchronising, None, x) for _ in range(3)]
        after = torch.ones(3, device=cuda) * 2   # the card works on
    for out in outs:
        assert torch.equal(out, x * 6.0)
    assert torch.equal(after, torch.full((3,), 2.0, device=cuda))
    st = graphs.stats()["sync"]
    assert (st["eager"], st["captures"], st["failed"]) == (3, 0, 1)
    assert st["error"]


@pytest.mark.gpu
def test_replayed_peak_memory_within_1_3_of_eager(cuda):
    cfg, params = _rgb(cuda)
    x = _rgb_inputs(cfg, 8, cuda, 0)

    def peak(graphed):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            _reenact(params, cfg, *x, graphed=graphed)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()

    eager = peak(False)
    assert peak(True) <= 1.3 * eager
