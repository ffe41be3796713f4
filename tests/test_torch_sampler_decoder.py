"""The sampler with the OSG decoder fused (`core/kernels/triplane.
sample_decode`) on the CPU: its plain version against the JAX package's
point evaluation, and the renderer's choice of route
(`renderer.decoder_fused`). The kernel itself runs only on the card:
`tests/test_torch_sampler_decoder_card.py`.

Tolerances are the port's: 1e-5 for the lookup (another rounding order
of the texel coordinate than JAX's) and for the decoder (fp32 products
summed in another order), as `test_torch_kernels.py` and
`test_torch_renderer.py` hold them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfa_gp_tpu.models.eg3d import renderer as jrnd
from hfa_gp_tpu_torch.core.kernels import triplane
from hfa_gp_tpu_torch.models.eg3d import renderer as trnd
from hfa_gp_tpu_torch.utils import convert
from tests.test_eg3d import small_config
from tests.test_torch_networks import torch_small_config

torch.set_num_threads(1)


def _decoder(seed=0, lr_mul=1.0, n_features=32):
    """A JAX decoder tree (numpy leaves), its biases made non-zero."""
    cfg = dataclasses.replace(small_config().render, decoder_lr_mul=lr_mul)
    dp = jax.tree.map(np.asarray, jrnd.init_decoder(
        jax.random.PRNGKey(seed), cfg, n_features))
    rng = np.random.default_rng(seed)
    for layer in ("fc0", "fc1"):
        dp[layer]["bias"] = (0.3 * rng.standard_normal(
            dp[layer]["bias"].shape)).astype(np.float32)
    return cfg, dp


def _planes_and_points(seed=0, b=2, hw=24, c=32, m=300):
    rng = np.random.default_rng(seed)
    planes = rng.standard_normal((b, 3, hw, hw + 4, c)).astype(np.float32)
    # most points inside the box, some leaving it (zeros padding)
    pts = rng.uniform(-0.75, 0.75, (b, m, 3)).astype(np.float32)
    return planes, pts


@pytest.mark.parametrize("box_warp,lr_mul", [(1.0, 1.0), (1.6, 0.5)])
def test_plain_fused_version_matches_jax_point_evaluation(box_warp, lr_mul):
    """`sample_decode_plain` against JAX's sampler, then its
    `decoder_apply` (which averages the planes itself)."""
    planes, pts = _planes_and_points()
    jcfg, dp = _decoder(1, lr_mul)
    feats = jrnd.sample_from_planes(jnp.asarray(planes), jnp.asarray(pts),
                                    box_warp)
    want = jrnd.decoder_apply(dp, jcfg, feats)
    got = triplane.sample_decode_plain(
        torch.from_numpy(planes), torch.from_numpy(pts), box_warp,
        convert.from_jax(dp), lr_mul)
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-5)
    # the colours are not all at their clamp, nor the densities all equal
    assert 0.05 < float(got[0].std()) and float(got[1].std()) > 0.1


def test_sample_decode_routes_cpu_tensors_to_the_plain_version():
    planes, pts = (torch.from_numpy(a) for a in _planes_and_points(2))
    dec = convert.from_jax(_decoder(2)[1])
    n0 = (triplane.LAUNCHES, triplane.LAUNCHES_DECODE)
    got = triplane.sample_decode(planes, pts, 1.0, dec, 1.0,
                                 layout=(1, 300, 1))
    want = triplane.sample_decode_plain(planes, pts, 1.0, dec, 1.0)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=0, atol=0)
    assert (triplane.LAUNCHES, triplane.LAUNCHES_DECODE) == n0
    with pytest.raises(ValueError, match="layout"):
        triplane.sample_decode(planes, pts, 1.0, dec, 1.0, layout=(2, 2, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        triplane.sample_decode(planes.to("meta"), pts.to("meta"), 1.0, dec,
                               1.0)


def test_decoder_apply_is_the_plain_decoder_arithmetic():
    """The renderer's decoder and the fused route's plain version share
    one arithmetic: the same features give the same bits."""
    planes, pts = (torch.from_numpy(a) for a in _planes_and_points(3))
    dec = convert.from_jax(_decoder(3)[1])
    feats = triplane.sample_mean_plain(planes, pts, 1.0)
    got = trnd.decoder_apply(dec, torch_small_config().render, feats)
    want = triplane.sample_decode_plain(planes, pts, 1.0, dec, 1.0)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=0, atol=0)


# -- the route ---------------------------------------------------------------


def _route_inputs(c=32, hidden=64):
    cfg = torch_small_config().render
    planes = torch.randn((2, 3, 8, 8, c))
    pts = torch.rand((2, 40, 3)) - 0.5
    dec = {"fc0": {"weight": torch.randn(hidden, c),
                   "bias": torch.zeros(hidden)},
           "fc1": {"weight": torch.randn(33, hidden),
                   "bias": torch.zeros(33)}}
    return cfg, planes, pts, dec


def test_route_is_unfused_for_cpu_tensors():
    cfg, planes, pts, dec = _route_inputs()
    with torch.no_grad():
        assert not trnd.decoder_fused(cfg, planes, pts, dec, False)


@pytest.fixture
def cpu_fuses(monkeypatch):
    """The route's device test widened to the CPU, so that its other
    conditions can be tried here (the plain version stands in for the
    kernel)."""
    monkeypatch.setattr(trnd, "_FUSED_DEVICES", ("cuda", "cpu"))


@pytest.mark.parametrize("case", [
    "fused", "autograd_planes", "autograd_points", "autograd_decoder",
    "no_grad_with_leaves", "inference_with_leaves", "decoder_bf16", "remat",
    "c8", "c30", "hidden48", "float64"])
def test_route_fuses_only_where_every_condition_holds(cpu_fuses, case):
    c = {"c8": 8, "c30": 30}.get(case, 32)
    cfg, planes, pts, dec = _route_inputs(
        c=c, hidden=48 if case == "hidden48" else 64)
    remat = case == "remat"
    if case == "decoder_bf16":
        cfg = dataclasses.replace(cfg, decoder_dtype=torch.bfloat16)
    if case == "float64":
        planes = planes.double()
    if case in ("autograd_planes", "no_grad_with_leaves",
                "inference_with_leaves"):
        planes.requires_grad_(True)
    if case == "autograd_points":
        pts.requires_grad_(True)
    if case in ("autograd_decoder", "no_grad_with_leaves",
                "inference_with_leaves"):
        dec["fc1"]["bias"].requires_grad_(True)
    mode = {"no_grad_with_leaves": torch.no_grad(),
            "inference_with_leaves": torch.inference_mode()}.get(
                case, torch.enable_grad())
    with mode:
        fused = trnd.decoder_fused(cfg, planes, pts, dec, remat)
    assert fused == (case in ("fused", "no_grad_with_leaves",
                              "inference_with_leaves"))


def _render(dp, cfg, planes, o, d, spy_calls, monkeypatch):
    """render_rays with `sample_decode` and `sample_mean` counted."""
    for name in ("sample_decode", "sample_mean"):
        real = getattr(trnd.triplane, name)

        def spy(*a, _real=real, _name=name, **kw):
            spy_calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(trnd.triplane, name, spy)
    return trnd.render_rays(dp, cfg, planes, o, d)


def _render_inputs(seed=7, b=2, res=16, hw=32):
    from tests.test_torch_renderer import _render_inputs as inputs
    planes, dp, o, d = inputs(seed, b, res, hw)
    return (torch.from_numpy(planes), convert.from_jax(dp),
            torch.from_numpy(o), torch.from_numpy(d))


@pytest.mark.parametrize("mode", ["inference", "no_grad", "unfused"])
def test_render_rays_takes_the_route_once_a_pass(monkeypatch, mode):
    """Where the route holds, both passes evaluate their points through
    `sample_decode`, and the render equals the unfused one bit for bit on
    the CPU (the plain versions run the same ops)."""
    planes, dp, o, d = _render_inputs()
    cfg = torch_small_config("stratified").render
    with torch.no_grad():
        want = trnd.render_rays(dp, cfg, planes, o, d)
    monkeypatch.setattr(trnd, "_FUSED_DEVICES",
                        ("cuda",) if mode == "unfused" else ("cuda", "cpu"))
    calls = []
    ctx = torch.inference_mode() if mode == "inference" else torch.no_grad()
    with ctx:
        got = _render(dp, cfg, planes, o, d, calls, monkeypatch)
    route = "sample_mean" if mode == "unfused" else "sample_decode"
    assert calls == [route] * 2
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["autograd", "decoder_bf16", "remat"])
def test_render_rays_keeps_the_unfused_route(cpu_fuses, monkeypatch, case):
    """Under autograd (a fitting step), with the decoder in bf16 and with
    `remat` the renderer keeps `sample_mean` → `decoder_apply`, and the
    gradients reach the planes and the decoder."""
    planes, dp, o, d = _render_inputs(8)
    cfg = torch_small_config("stratified").render
    if case == "decoder_bf16":
        cfg = dataclasses.replace(cfg, decoder_dtype=torch.bfloat16)
    if case == "remat":
        cfg = dataclasses.replace(cfg, remat=True)
    if case == "decoder_bf16":
        with torch.no_grad():
            calls = []
            _render(dp, cfg, planes, o, d, calls, monkeypatch)
        assert calls == ["sample_mean"] * 2
        return
    planes.requires_grad_(True)
    dp.requires_grad_(True)
    calls = []
    outs = _render(dp, cfg, planes, o, d, calls, monkeypatch)
    sum(out.sum() for out in outs).backward()
    # remat evaluates each pass again in the backward
    assert calls == ["sample_mean"] * (4 if case == "remat" else 2)
    assert float(planes.grad.abs().max()) > 0
    assert all(float(p.grad.abs().max()) > 0 for p in dp.parameters())
