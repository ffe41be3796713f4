"""The port's inference stages as CUDA graphs (`core/graphs.py`) and the
host constants kept on the card (`core/ops.fir_taps`,
`ops.device_constant`).

On the CPU: the cached FIR taps give the NumPy-built taps' outputs bit
for bit at every (taps, gain, up/down) the configurations use; the graph
helper runs eagerly and counts it; its keys; its bound, with a stand-in
for the card's graphs that replays the stage on the CPU. Marked `gpu`
(card only): replayed units against eager ones under
`cudnn.deterministic`, equal or within `CAPTURE_RTOL`; the launch
counters; parameters replaced and changed in place; a one-off partial
batch; a capture that fails; peak memory.
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
