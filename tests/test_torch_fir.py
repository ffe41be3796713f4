"""The FIR kernel's wrapper (`core/kernels/fir.py`) and `ops.upfirdn2d`'s
routes: on the CPU the routes, the kernel's geometry and its adjoint
against the plain version; marked `gpu` (card only) the kernel against
the plain version at every call of a reenactment unit at batch 1, 2 and
8, in both memory layouts, fp32 and bf16, forward and backward, and its
launch counts eager and replayed.

No JAX here: the card's machine has none. The plain version is held to
the JAX package's upfirdn2d in `tests/test_torch_ops.py`.

Tolerances on the card: fp32 1e-6 of the output's largest magnitude (at
most 16 products a sum, taken in another order than cuDNN's); bf16 one
bf16 rounding (2⁻⁸) of the largest magnitude of the fp32 result on the
same bf16 inputs, since the kernel sums in fp32 and rounds once.
"""

import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hfa_gp_tpu_torch.core import graphs, ops
from hfa_gp_tpu_torch.core.kernels import build, fir

torch.set_num_threads(1)

FIR = ops.make_fir_kernel([1, 3, 3, 1])
ASYM = np.random.default_rng(7).uniform(0.1, 1.0, (4, 3)).astype(np.float32)

# (up, down, pad, gain, taps): the port's calls (the modulated conv's FIR
# after its transposed conv, the torgb skip's upsample2d, the encoder's
# blurs before its 3x3 and 1x1 stride-2 convs, downsample2d and the
# upsample2d's adjoint), then asymmetric taps at every factor pair
CALLS = {
    "modconv_up": (1, 1, (1, 1), 4.0, FIR),
    "upsample2d": (2, 1, (2, 1), 4.0, FIR),
    "blur_3x3": (1, 1, (2, 2), 1.0, FIR),
    "blur_1x1": (1, 1, (1, 1), 1.0, FIR),
    "downsample2d": (1, 2, (1, 1), 1.0, FIR),
    "asym_1_1": (1, 1, (1, 2), 1.5, ASYM),
    "asym_2_1": (2, 1, (2, 1), 1.5, ASYM),
    "asym_1_2": (1, 2, (1, 1), 1.5, ASYM),
    "asym_2_2": (2, 2, (0, 3), 1.5, ASYM),
    "crop": (1, 1, (-1, 2), 1.0, FIR),
}
LAYOUTS = {"nchw": torch.contiguous_format, "cl": torch.channels_last}


def _x(shape=(2, 5, 9, 11), layout="nchw", dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype) \
        .contiguous(memory_format=LAYOUTS[layout])


def _indexed(x: torch.Tensor, geom: fir.Geometry) -> torch.Tensor:
    """What the kernel computes, by its index arithmetic (`fir.Geometry`'s
    docstring), tap by tap: y[o] += f[t] · x[(o·down + t − p0) / up] where
    up divides the stuffed index and the point lies in x."""
    h, w = x.shape[2:]
    y = torch.zeros(x.shape[:2] + (geom.out_h, geom.out_w), dtype=x.dtype)

    def axis(n_out, n_in, t, p0):
        j = torch.arange(n_out) * geom.down + t - p0
        ok = (j % geom.up == 0) & (j >= 0) & (j < n_in * geom.up)
        return (j // geom.up).clamp(0, n_in - 1), ok

    for ty, row in enumerate(geom.taps):
        iy, oky = axis(geom.out_h, h, ty, geom.py0)
        for tx, f in enumerate(row):
            ix, okx = axis(geom.out_w, w, tx, geom.px0)
            mask = (oky[:, None] & okx[None, :]).to(x.dtype)
            y += f * x[:, :, iy][:, :, :, ix] * mask
    return y


# -- on the CPU ---------------------------------------------------------------


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("call", sorted(CALLS))
def test_cpu_route_is_the_plain_version_and_keeps_the_layout(call, layout):
    up, down, pad, gain, taps = CALLS[call]
    x = _x(layout=layout)
    n0, n1 = fir.LAUNCHES, fir.LAUNCHES_BWD
    got = ops.upfirdn2d(x, taps, up=up, down=down, pad=pad, gain=gain)
    want = ops.upfirdn2d_plain(x, taps, up=up, down=down, pad=pad,
                               gain=gain)
    assert torch.equal(got, want)
    geom = fir.geometry(9, 11, taps, up, down, pad, gain)
    assert got.shape == (2, 5, geom.out_h, geom.out_w)
    if up == 1:         # the plain version's zero-stuffing reshapes to NCHW
        assert got.is_contiguous(memory_format=LAYOUTS[layout])
    assert (fir.LAUNCHES, fir.LAUNCHES_BWD) == (n0, n1)


@pytest.mark.parametrize("call", sorted(CALLS))
def test_the_kernels_geometry_computes_the_plain_version(call):
    up, down, pad, gain, taps = CALLS[call]
    x = _x(dtype=torch.float64)
    geom = fir.geometry(9, 11, taps, up, down, pad, gain)
    want = ops.upfirdn2d_plain(x, taps, up=up, down=down, pad=pad, gain=gain)
    torch.testing.assert_close(_indexed(x, geom), want, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("call", sorted(CALLS))
def test_the_adjoint_geometry_is_the_transpose(call):
    """⟨A x, y⟩ = ⟨x, Aᵀ y⟩ with Aᵀ from `fir.adjoint`, and Aᵀ y is the
    gradient autograd takes through the plain version."""
    up, down, pad, gain, taps = CALLS[call]
    x = _x(dtype=torch.float64).requires_grad_(True)
    geom = fir.geometry(9, 11, taps, up, down, pad, gain)
    adj = fir.adjoint(geom, 9, 11)
    assert (adj.up, adj.down) == (down, up)
    y = ops.upfirdn2d_plain(x, taps, up=up, down=down, pad=pad, gain=gain)
    cot = _x(tuple(y.shape), dtype=torch.float64, seed=1)
    (want,) = torch.autograd.grad(y, x, cot)
    got = _indexed(cot, adj)
    assert got.shape == x.shape
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    lhs = float((y.detach() * cot).sum())
    rhs = float((x.detach() * got).sum())
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)
    assert fir.adjoint(adj, *y.shape[2:]) == geom


# the discriminator's FIRs (EG3D's resnet blocks): before the skip's 1x1
# convolution, down 2; before conv1's stride-2 3x3, pad 2
R1_CALLS = {"skip": (2, (1, 1)), "conv1": (1, (2, 2))}


def _r1(fir_fn, x, w):
    """R1 through a FIR: the logits' gradient in x (create_graph), then the
    penalty's backward → (that gradient, w's and x's gradients)."""
    x = x.detach().clone().requires_grad_(True)
    w = w.detach().clone().requires_grad_(True)
    logits = F.leaky_relu(F.conv2d(fir_fn(x), w), 0.2).square() \
        .mean((1, 2, 3))
    (gx,) = torch.autograd.grad(logits.sum(), x, create_graph=True)
    gx.square().sum().backward()
    return gx.detach(), w.grad, x.grad


def _launches():
    return fir.LAUNCHES, fir.LAUNCHES_BWD, fir.LAUNCHES_BWD2


@pytest.mark.parametrize("call", sorted(R1_CALLS))
def test_the_autograd_function_is_differentiable_twice(call, monkeypatch):
    """R1 through `_UpFirDn2d` with the kernel's index arithmetic standing
    in for the launch, against autograd through the plain version, in
    float64: one forward launch, a backward one for the input gradient and
    one for the penalty's way back to x, and one second-order launch."""
    down, pad = R1_CALLS[call]
    monkeypatch.setattr(fir, "_launch", _indexed)
    x = _x((2, 3, 12, 12), dtype=torch.float64)
    w = _x((4, 3, 3, 3), dtype=torch.float64, seed=2)
    geom = fir.geometry(12, 12, FIR, 1, down, pad, 1.0)
    n0 = _launches()
    got = _r1(lambda t: fir._UpFirDn2d.apply(t, geom, 0), x, w)
    assert tuple(a - b for a, b in zip(_launches(), n0)) == (1, 2, 1)
    want = _r1(lambda t: ops.upfirdn2d_plain(t, FIR, down=down, pad=pad),
               x, w)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)
    assert float(got[1].norm()) > 0 and float(got[2].norm()) > 0


def test_cpu_and_float64_take_the_plain_version():
    n0 = fir.LAUNCHES
    x = _x(dtype=torch.float64)
    got = ops.upsample2d(x, FIR)
    assert got.dtype == torch.float64
    assert torch.equal(got, ops.upfirdn2d_plain(x, FIR, up=2, pad=(2, 1),
                                                gain=4.0))
    assert fir.LAUNCHES == n0


@pytest.mark.parametrize("kw", [{"up": 3}, {"down": 3}, {"up": 0},
                                {"taps": np.ones((5, 4), np.float32)},
                                {"taps": np.ones((1, 5), np.float32)},
                                {"taps": np.ones((2, 2, 2), np.float32)}])
def test_unsupported_factors_and_taps_raise_on_every_device(kw):
    kw = dict(kw)
    taps = kw.pop("taps", FIR)
    with pytest.raises(ValueError, match="upfirdn2d"):
        ops.upfirdn2d(_x(), taps, **kw)


def test_a_geometry_without_output_raises():
    with pytest.raises(ValueError, match="no output"):
        fir.geometry(9, 11, FIR, 1, 1, (-3, -3), 1.0)


def test_the_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="CUDA"):
        fir.upfirdn2d(_x(), FIR)
    with pytest.raises(ValueError, match="channels-last"):
        fir._channels_last(_x().transpose(2, 3))
    assert fir._channels_last(_x(layout="cl"))
    assert not fir._channels_last(_x())
    # SR's image: the first three channels of the channels-last features
    assert fir._channels_last(_x((2, 32, 9, 11), layout="cl")[:, :3])
    assert not fir._channels_last(_x((2, 5, 9, 14))[..., 1:12])


def test_the_wrapper_knows_the_kernels_limits_and_its_counters_replay():
    with open(os.path.join(build.CSRC_DIR, "upfirdn2d.cu")) as f:
        src = f.read()
    assert re.search(r"constexpr int MAX_TAPS = (\d+);", src).group(1) == \
        str(fir.MAX_TAPS)
    assert (fir, "LAUNCHES") in graphs.COUNTERS
    assert (fir, "LAUNCHES_BWD") in graphs.COUNTERS


def test_taps_are_flipped_and_scaled_once():
    geom = fir.geometry(9, 11, ASYM, 1, 1, (1, 2), 1.5)
    np.testing.assert_array_equal(np.array(geom.taps, np.float32),
                                  ASYM[::-1, ::-1] * np.float32(1.5))
    assert fir.geometry(9, 11, ASYM.copy(), 1, 1, (1, 2), 1.5).taps \
        is geom.taps


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda(monkeypatch):
    """The card with TF32 off, as the CLIs set it, and no graphs kept."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    graphs.reset()
    yield torch.device("cuda")
    graphs.reset()


def _rgb_unit(device, b, seed=0):
    """The RGB avatar at full width and a batch of inputs."""
    from hfa_gp_tpu_torch.core import camera as cam
    from hfa_gp_tpu_torch.models.avatar import heads
    cfg = heads.AvatarConfig()
    params = heads.init_avatar_rgb(torch.Generator().manual_seed(seed), cfg,
                                   device)
    g = torch.Generator().manual_seed(seed + 1)
    image = torch.rand((b, cfg.size, cfg.size, 3), generator=g) * 2 - 1
    label = cam.flip_yz_label(cam.sample_camera_label(g, n=b))
    return cfg, params, image.to(device), label.to(device)


def _reenact(params, cfg, image, label, graphed):
    from hfa_gp_tpu_torch.cli.run_recon_video_rgb import reenact
    with torch.inference_mode() if graphed else torch.enable_grad():
        return reenact(params, cfg, image, label)


def _recorded_calls(monkeypatch, run) -> list:
    """The (shape, layout, up, down, pad, gain, taps) of every kernel call
    `run()` makes."""
    calls, wrapped = [], fir.upfirdn2d

    def record(x, taps, *, up=1, down=1, pad=(0, 0), gain=1.0):
        layout = "nchw" if x.is_contiguous() else "cl"
        calls.append((tuple(x.shape), layout, up, down, tuple(pad), gain,
                      np.asarray(taps).tobytes()))
        return wrapped(x, taps, up=up, down=down, pad=pad, gain=gain)

    monkeypatch.setattr(fir, "upfirdn2d", record)
    run()
    monkeypatch.setattr(fir, "upfirdn2d", wrapped)
    return calls


def _check(got, want, scale, tol, what):
    err = float((got.detach().float() - want.detach().float()).abs().max()) \
        / scale
    assert err <= tol, (what, err)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2, 8])
def test_kernel_matches_plain_at_every_call_of_a_unit(cuda, monkeypatch, b):
    cfg, params, image, label = _rgb_unit(cuda, b)
    calls = _recorded_calls(
        monkeypatch, lambda: _reenact(params, cfg, image, label, False))
    assert len(calls) == 28
    # channels-last: the encoder's 12 blurs and SR's two upsample2d of its
    # image (the first three channels of the channels-last features)
    assert sum(c[1] == "cl" for c in calls) == 14
    del params, image, label
    for shape, _, up, down, pad, gain, raw in sorted(set(calls)):
        taps = np.frombuffer(raw, np.float32).reshape(4, 4)
        kw = dict(up=up, down=down, pad=pad, gain=gain)
        for layout in LAYOUTS:
            what = (shape, layout, up, down, pad, gain)
            x = torch.randn(shape, device=cuda) \
                .contiguous(memory_format=LAYOUTS[layout])
            # fp32, forward and backward
            xk = x.clone().requires_grad_(True)
            xp = x.clone().requires_grad_(True)
            yk = ops.upfirdn2d(xk, taps, **kw)
            yp = ops.upfirdn2d_plain(xp, taps, **kw)
            assert yk.is_contiguous(memory_format=LAYOUTS[layout])
            scale = float(yp.detach().abs().max())
            _check(yk, yp.detach(), scale, 1e-6, ("fwd",) + what)
            cot = torch.randn_like(yk)
            yk.backward(cot)
            yp.backward(cot)
            assert xk.grad.is_contiguous(memory_format=LAYOUTS[layout])
            _check(xk.grad, xp.grad, float(xp.grad.abs().max()), 1e-6,
                   ("bwd",) + what)
            del xk, xp, yk, yp
            # bf16: against fp32 on the same bf16 inputs
            xb = x.bfloat16().requires_grad_(True)
            xr = xb.detach().float().requires_grad_(True)
            yb = ops.upfirdn2d(xb, taps, **kw)
            yr = ops.upfirdn2d_plain(xr, taps, **kw)
            assert yb.dtype == torch.bfloat16
            _check(yb, yr.detach(), float(yr.abs().max()), 2 ** -8,
                   ("bf16 fwd",) + what)
            cotb = cot.bfloat16()
            yb.backward(cotb)
            yr.backward(cotb.float())
            _check(xb.grad, xr.grad, float(xr.grad.abs().max()), 2 ** -8,
                   ("bf16 bwd",) + what)
            del x, xb, xr, yb, yr, cot, cotb
            torch.cuda.empty_cache()


@pytest.mark.gpu
def test_launches_a_unit_eager_and_replayed(cuda):
    from hfa_gp_tpu_torch.core import camera as cam
    from hfa_gp_tpu_torch.train import audio
    cfg, params, image, label = _rgb_unit(cuda, 2)

    def launches(fn):
        n0, n1 = fir.LAUNCHES, fir.LAUNCHES_BWD
        out = fn()
        return fir.LAUNCHES - n0, fir.LAUNCHES_BWD - n1, out

    eager = launches(lambda: _reenact(params, cfg, image, label, False))
    assert eager[:2] == (28, 0)
    for i in range(4):          # eager, captured, replayed twice
        n, nb, out = launches(lambda: _reenact(params, cfg, image, label,
                                               True))
        assert (n, nb) == (28, 0), i
        # a capture may take other cuDNN engines than the eager run
        # (`tests/test_torch_graphs.py`'s CAPTURE_RTOL)
        assert float((out - eager[2]).norm() / eager[2].norm()) <= 2e-6, i
    assert graphs.stats()["superres"]["replays"] == 2
    del params
    aparams = audio.init_audio_params(torch.Generator().manual_seed(1), cfg,
                                      cuda)
    g = torch.Generator().manual_seed(2)
    win = torch.randn((2, cfg.smo_size, 16, 29), generator=g).to(cuda)
    lab = cam.flip_yz_label(cam.sample_camera_label(g, n=2)).to(cuda)
    for i in range(3):
        n, nb, _ = launches(lambda: audio.sample(aparams, cfg, win, lab,
                                                 smooth=True))
        assert (n, nb) == (16, 0), i


@pytest.mark.gpu
def test_every_fir_that_needs_a_gradient_launches_one_backward(cuda,
                                                               monkeypatch):
    cfg, params, image, label = _rgb_unit(cuda, 1)
    for leaf in params.parameters():
        leaf.requires_grad_(True)
    needing = []
    wrapped = fir.upfirdn2d

    def record(x, taps, **kw):
        needing.append(x.requires_grad)
        return wrapped(x, taps, **kw)

    monkeypatch.setattr(fir, "upfirdn2d", record)
    n0, n1 = fir.LAUNCHES, fir.LAUNCHES_BWD
    out = _reenact(params, cfg, image, label, False)
    out.square().mean().backward()
    assert fir.LAUNCHES - n0 == len(needing) == 28
    assert fir.LAUNCHES_BWD - n1 == sum(needing) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("call", sorted(R1_CALLS))
def test_r1_runs_through_the_kernel_at_second_order(cuda, call, layout):
    """R1's gradient of an input gradient through K9 against the plain
    version at a discriminator block's shape: the input gradient, the
    weights' and the input's gradients within 1e-5 of their largest
    magnitude; the forward and first-order launches as a first-order
    pass makes them, and the second-order counter counting the rest."""
    down, pad = R1_CALLS[call]
    g = torch.Generator().manual_seed(5)
    x = torch.randn((4, 64, 64, 64), generator=g).to(cuda) \
        .contiguous(memory_format=LAYOUTS[layout])
    w = torch.randn((32, 64, 3, 3), generator=g).to(cuda) / 24
    n0 = _launches()
    got = _r1(lambda t: ops.upfirdn2d(t, FIR, down=down, pad=pad), x, w)
    assert tuple(a - b for a, b in zip(_launches(), n0)) == (1, 2, 1)
    n0 = _launches()
    want = _r1(lambda t: ops.upfirdn2d_plain(t, FIR, down=down, pad=pad),
               x, w)
    assert _launches() == n0
    for what, a, b in zip(("grad", "w", "x"), got, want):
        _check(a, b, float(b.abs().max()), 1e-5, (what, call, layout))
    # a first-order pass launches as before and nothing at second order
    n0 = _launches()
    xk = x.clone().requires_grad_(True)
    ops.upfirdn2d(xk, FIR, down=down, pad=pad).square().sum().backward()
    assert tuple(a - b for a, b in zip(_launches(), n0)) == (1, 1, 0)
