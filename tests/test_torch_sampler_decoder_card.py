"""The fused sampler + OSG decoder kernel on the card (`gpu`: skips
without one). It is held to its plain version at the shapes the avatar
cells render, to the unfused route (K1, then the decoder's PyTorch ops),
and through the renderer, the launch counters and a CUDA graph replay.
Run on the card: `python -m pytest -m gpu
tests/test_torch_sampler_decoder_card.py`.

Tolerances: against the unfused route, whose features are K1's to the
bit, the kernel differs only in the order of the decoder's fp32 sums:
1e-5 of each output's scale. Against the plain version the features come
from `F.grid_sample`, which rounds the texel coordinate in another order
(the port's sampler bound, 1e-4, as `chip_smoke.py` holds K1). A whole
render: ‖fused − unfused‖ ≤ 1e-6 · ‖unfused‖ for each output.
"""

import math

import pytest
import torch

from hfa_gp_tpu_torch.core import graphs
from hfa_gp_tpu_torch.core.kernels import triplane
from hfa_gp_tpu_torch.models.eg3d import renderer

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _decoder(dev, seed=0, c=32):
    """EG3D's decoder init (unit normal weights), with non-zero biases."""
    g = torch.Generator().manual_seed(seed)
    return {"fc0": {"weight": torch.randn(64, c, generator=g).to(dev),
                    "bias": (0.3 * torch.randn(64, generator=g)).to(dev)},
            "fc1": {"weight": torch.randn(33, 64, generator=g).to(dev),
                    "bias": (0.3 * torch.randn(33, generator=g)).to(dev)}}


def _rays(dev, b, res, seed=0):
    """(origins, directions) (b, res², 3): cameras at radius 2.7 around the
    frontal pose, looking at the origin, a 12° field of view."""
    g = torch.Generator().manual_seed(seed)
    yaw = 0.3 * torch.randn(b, generator=g)
    pitch = 0.15 * torch.randn(b, generator=g)
    eye = 2.7 * torch.stack([torch.sin(yaw) * torch.cos(pitch),
                             torch.sin(pitch),
                             torch.cos(yaw) * torch.cos(pitch)], -1)
    fwd = -eye / eye.norm(dim=-1, keepdim=True)
    up = torch.tensor([0.0, 1.0, 0.0]).expand(b, 3)
    right = torch.linalg.cross(fwd, up)
    right = right / right.norm(dim=-1, keepdim=True)
    up = torch.linalg.cross(right, fwd)
    s = torch.linspace(-1, 1, res) * math.tan(math.radians(6.0))
    v, u = torch.meshgrid(s, s, indexing="ij")
    d = (fwd[:, None] + u.reshape(1, -1, 1) * right[:, None]
         + v.reshape(1, -1, 1) * up[:, None])
    d = d / d.norm(dim=-1, keepdim=True)
    return eye[:, None].expand(b, res * res, 3).contiguous().to(dev), \
        d.contiguous().to(dev)


def _points(dev, b, res=128, n=48, seed=0):
    """(b, res²·n, 3) points of the coarse pass: n depths in [2.25, 3.3]
    along each ray, as the cells render."""
    o, d = _rays(dev, b, res, seed)
    z = torch.linspace(2.25, 3.3, n, device=dev)
    return (o[:, :, None] + z[None, None, :, None] * d[:, :, None]) \
        .reshape(b, -1, 3).contiguous()


def _scale_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("b", [8, 1])
def test_fused_kernel_matches_plain_at_the_cells_shapes(cuda, b):
    g = torch.Generator().manual_seed(b)
    planes = torch.randn((b, 3, 256, 256, 32), generator=g).to(cuda)
    pts = _points(cuda, b, seed=b)
    dec = _decoder(cuda, b)
    with torch.inference_mode():
        rgb, sigma = triplane.sample_decode(planes, pts, 1.0, dec, 1.0)
        unfused = triplane.decode_plain(
            dec, 1.0, triplane.sample_mean(planes, pts, 1.0))
        plain = triplane.sample_decode_plain(planes, pts, 1.0, dec, 1.0)
    assert rgb.shape == (b, 16384 * 48, 32) and sigma.shape == \
        (b, 16384 * 48, 1)
    assert rgb.is_contiguous() and sigma.is_contiguous()
    for got, want_u, want_p in zip((rgb, sigma), unfused, plain):
        assert bool(torch.isfinite(got).all())
        assert _scale_err(got, want_u) <= 1e-5
        assert _scale_err(got, want_p) <= 1e-4
    # the points see the planes: colours spread, densities not all zero
    assert float(rgb.std()) > 0.05 and float(sigma.abs().max()) > 1.0


@pytest.mark.gpu
def test_fused_kernel_at_ragged_counts_off_plane_and_other_gains(cuda):
    """Point counts that leave a partial round and block, points outside
    the planes, non-square planes and lr_mul 0.5."""
    g = torch.Generator().manual_seed(3)
    dec = _decoder(cuda, 3)
    for b, m, h, w in ((3, 1101, 24, 40), (1, 77, 16, 16),
                       (2, 40000, 64, 64)):
        planes = torch.randn((b, 3, h, w, 32), generator=g).to(cuda)
        pts = ((torch.rand((b, m, 3), generator=g) - 0.5) * 2.4).to(cuda)
        with torch.inference_mode():
            got = triplane.sample_decode(planes, pts, 1.6, dec, 0.5)
            want = triplane.decode_plain(
                dec, 0.5, triplane.sample_mean(planes, pts, 1.6))
        for x, y in zip(got, want):
            assert _scale_err(x, y) <= 1e-5, (b, m, h, w)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [8, 30])
def test_other_widths_refuse_the_kernel_and_render_unfused(cuda, c):
    """At C 8 and 30 the kernel refuses (ValueError), the route does not
    engage, and the renderer takes K1's general path."""
    g = torch.Generator().manual_seed(c)
    planes = torch.randn((1, 3, 32, 32, c), generator=g).to(cuda)
    dec = _decoder(cuda, c, c=c)
    o, d = _rays(cuda, 1, 16)
    cfg = renderer.RenderConfig(depth_resolution=8,
                                depth_resolution_importance=8,
                                neural_rendering_resolution=16)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="fused kernel takes"):
            triplane.sample_decode(planes, o, 1.0, dec, 1.0)
        assert not renderer.decoder_fused(cfg, planes, o, dec, False)
        n0 = (triplane.LAUNCHES, triplane.LAUNCHES_DECODE)
        got = renderer.render_rays(dec, cfg, planes, o, d)
        assert (triplane.LAUNCHES - n0[0], triplane.LAUNCHES_DECODE
                - n0[1]) == (2, 0)
        dec_cpu = {k: {n: t.cpu() for n, t in layer.items()}
                   for k, layer in dec.items()}
        want = renderer.render_rays(dec_cpu, cfg, planes.cpu(), o.cpu(),
                                    d.cpu())
    for x, y in zip(got, want):
        torch.testing.assert_close(x.cpu(), y, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernel_cannot_give(cuda):
    planes = torch.randn((1, 3, 16, 16, 32), device=cuda)
    pts = torch.rand((1, 100, 3), device=cuda) - 0.5
    dec = _decoder(cuda)
    with pytest.raises(ValueError, match="no gradient"):
        triplane.sample_decode(planes.requires_grad_(True), pts, 1.0, dec,
                               1.0)
    planes.requires_grad_(False)
    with pytest.raises(ValueError, match="contiguous fp32"):
        triplane.sample_decode(planes.double(), pts, 1.0, dec, 1.0)
    with pytest.raises(ValueError, match="contiguous fp32"):
        bad = {**dec, "fc1": {"weight": dec["fc1"]["weight"].t()
                              .contiguous().t(), "bias": dec["fc1"]["bias"]}}
        triplane.sample_decode(planes, pts, 1.0, bad, 1.0)


def _render_unit(cuda, b=2):
    """Full-width render inputs: planes (b, 3, 256, 256, 32), 128² rays,
    48 + 48 samples, the stratified fine placement of the cells."""
    g = torch.Generator().manual_seed(11)
    planes = torch.randn((b, 3, 256, 256, 32), generator=g).to(cuda)
    o, d = _rays(cuda, b, 128, seed=11)
    return renderer.RenderConfig(), planes, _decoder(cuda, 11), o, d


@pytest.mark.gpu
def test_render_rays_fused_matches_unfused(cuda, monkeypatch):
    cfg, planes, dec, o, d = _render_unit(cuda)
    with torch.inference_mode():
        n0 = triplane.LAUNCHES_DECODE
        fused = renderer.render_rays(dec, cfg, planes, o, d,
                                     ray_grid=(128, 128))
        assert triplane.LAUNCHES_DECODE - n0 == 2
        monkeypatch.setattr(renderer, "_FUSED_DEVICES", ())
        unfused = renderer.render_rays(dec, cfg, planes, o, d,
                                       ray_grid=(128, 128))
        assert triplane.LAUNCHES_DECODE - n0 == 2
    for x, y in zip(fused, unfused):
        assert float((x - y).norm() / y.norm()) <= 1e-6
    assert float(fused[2].max()) > 0.1          # the rays hit something


@pytest.mark.gpu
def test_decoder_launches_two_a_render_and_none_a_fitting_step(cuda):
    cfg, planes, dec, o, d = _render_unit(cuda, b=1)
    n0 = (triplane.LAUNCHES, triplane.LAUNCHES_DECODE, triplane.LAUNCHES_BWD)

    def moved():
        return (triplane.LAUNCHES - n0[0], triplane.LAUNCHES_DECODE - n0[1],
                triplane.LAUNCHES_BWD - n0[2])

    with torch.inference_mode():
        renderer.render_rays(dec, cfg, planes, o, d)
    assert moved() == (2, 2, 0)
    # a fitting step: the planes and the decoder train
    planes.requires_grad_(True)
    for layer in dec.values():
        for t in layer.values():
            t.requires_grad_(True)
    outs = renderer.render_rays(dec, cfg, planes, o, d)
    sum(x.sum() for x in outs).backward()
    assert moved() == (4, 2, 2)
    assert float(planes.grad.abs().max()) > 0


@pytest.mark.gpu
def test_a_graph_replay_advances_the_decoder_counter(cuda):
    """The render stage captured and replayed (`core.graphs`): a replay
    gives the eager frames and advances `LAUNCHES_DECODE` by the graph's
    two launches."""
    cfg, planes, dec, o, d = _render_unit(cuda, b=1)
    graphs.reset()

    def stage(params, p, oo, dd):
        return renderer.render_rays(params, cfg, p, oo, dd)

    with torch.inference_mode():
        outs, moved = [], []
        for _ in range(4):
            n0 = (triplane.LAUNCHES, triplane.LAUNCHES_DECODE)
            outs.append(graphs.run("render_decoder_test", stage, dec, planes,
                                   o, d))
            moved.append((triplane.LAUNCHES - n0[0],
                          triplane.LAUNCHES_DECODE - n0[1]))
    st = graphs.stats()["render_decoder_test"]
    assert st["captures"] == 1 and st["replays"] == 2 and st["failed"] == 0
    assert moved == [(2, 2)] * 4
    for later in outs[1:]:
        for x, y in zip(later, outs[0]):
            assert torch.equal(x, y)
    graphs.reset()
