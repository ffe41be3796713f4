"""The port's `--bf16` route and the renderer's `ray_chunk` / `remat`
against the JAX package, at tests/test_eg3d.py's small_config widths.

bf16: each op runs in the dtype of x; the EG3D synthesis chains and the
OSG decoder run in bf16, torgb outputs, planes, images and losses in fp32.
Both packages round to bf16 (8 bits of mantissa, 2^-9 relative) in other
places: the port folds w·s·d in fp32 and rounds the per-sample weight
once, JAX rounds x·s and y·d (`core/ops.py` of each). So bf16 results are
held to JAX's bf16 in the L2 norm over the whole tensor, relative to its
norm (1e-2 for one conv, 2.5e-2 for whole renders; PARITY.md delta 1
expects about 2e-2 between bf16 and fp32), and each package's bf16 is
held against its own fp32 too: the port's gap to its fp32 must lie within
a factor of 4 of JAX's gap, so a port that skipped a cast (no gap) or
added one (a larger gap) fails.

Gradients: JAX's bf16 step is far from its own fp32 step on the CPU
(30–47 % in L2 for the encoder, the subspace and SR: the x·s / y·d order
rounds the terms of the demodulation's near-cancelling gradient, and its
bf16 reductions), while the port's is within 1.5 %. So the port's bf16
gradients are held to the exact fp32 gradients at 3e-2 in L2, by a gap
above 1e-4 (bf16 ran), and to JAX's bf16 gradients no further than twice
JAX's own bf16-vs-fp32 gap. The exact fp32 gradients are the port's, which
tests/test_torch_train.py holds to JAX's fp32 step at 1e-4.

ray_chunk / remat: rendering in chunks equals JAX's chunked render (1e-4)
and the port's unchunked one to fp32 rounding (1e-6: the decoder's
products are summed in blocks of other sizes) apart from the depth clip,
which is per chunk as in JAX; remat changes no value or gradient (bit for
bit).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfa_gp_tpu.core import ops as jops
from hfa_gp_tpu.models.eg3d import generator as jgen
from hfa_gp_tpu.models.eg3d import networks as jnets
from hfa_gp_tpu.models.eg3d import renderer as jrnd
from hfa_gp_tpu.models import lpips as jlpips
from hfa_gp_tpu.models.avatar import heads as jheads
from hfa_gp_tpu.train import rgb as jrgb
from hfa_gp_tpu_torch.cli import common
from hfa_gp_tpu_torch.core import ops as tops
from hfa_gp_tpu_torch.models.eg3d import generator as tgen
from hfa_gp_tpu_torch.models.eg3d import networks as tnets
from hfa_gp_tpu_torch.models.eg3d import renderer as trnd
from hfa_gp_tpu_torch.train import rgb as trgb
from hfa_gp_tpu_torch.utils import convert
from tests.test_eg3d import small_config
from tests.test_torch_networks import numpy_tree, torch_small_config
from tests.test_torch_renderer import _render_inputs, _t
from tests.test_torch_train import JCFG, TCFG, _leaves

# One intra-op thread: the suite runs several worker processes side by
# side, and a thread pool per worker as wide as the machine makes them wait
# on each other.
torch.set_num_threads(1)

BF16 = torch.bfloat16


def _l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _hold_bf16(t16, t32, j16, j32, rtol):
    """The port's bf16 against JAX's bf16 (L2, rtol) and each against its
    own fp32: the port's gap within a factor of 4 of JAX's."""
    assert _l2(t16, j16) <= rtol, _l2(t16, j16)
    gap_t, gap_j = _l2(t16, t32), _l2(j16, j32)
    assert gap_j > 1e-4, gap_j                  # JAX really ran bf16
    assert gap_j / 4 <= gap_t <= 4 * gap_j, (gap_t, gap_j)


def _jax16(cfg):
    """A JAX EG3DConfig with --bf16's compute and decoder dtypes."""
    return dataclasses.replace(cfg, compute_dtype=jnp.bfloat16,
                               render=dataclasses.replace(
                                   cfg.render, decoder_dtype=jnp.bfloat16))


def _torch16(cfg):
    return dataclasses.replace(cfg, compute_dtype=BF16,
                               render=dataclasses.replace(
                                   cfg.render, decoder_dtype=BF16))


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32)) if not \
        isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("up", [1, 2])
@pytest.mark.parametrize("demodulate", [True, False])
def test_modulated_conv2d_bf16_matches_jax(up, demodulate):
    rng = np.random.default_rng(up + 2 * demodulate)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    w = rng.standard_normal((3, 3, 16, 24)).astype(np.float32)
    s = (rng.standard_normal((2, 16)) + 1).astype(np.float32)
    jfn = jax.jit(lambda x_, dt: jops.modulated_conv2d(
        x_.astype(dt), jnp.asarray(w), jnp.asarray(s), up=up, padding=1,
        demodulate=demodulate), static_argnums=1)
    tx = _t(x).permute(0, 3, 1, 2)
    tw = _t(w).permute(3, 2, 0, 1)

    def port(dtype):
        y = tops.modulated_conv2d(tx.to(dtype), tw, _t(s), up=up, padding=1,
                                  demodulate=demodulate)
        assert y.dtype == dtype
        return y.float().permute(0, 2, 3, 1).numpy()

    _hold_bf16(port(BF16), port(torch.float32),
               _f32(jfn(jnp.asarray(x), jnp.bfloat16)),
               _f32(jfn(jnp.asarray(x), jnp.float32)), 1e-2)


@pytest.fixture(scope="module")
def gen_params():
    cfg = small_config()
    jp = numpy_tree(jax.jit(lambda k: jgen.init_generator(k, cfg))(
        jax.random.PRNGKey(0)), np.random.default_rng(0))
    return cfg, jp, convert.from_jax(jp)


def test_backbone_bf16_matches_jax(gen_params):
    """The planes leave the backbone in fp32 (torgb cast) in both."""
    cfg, jp, tp = gen_params
    ws = np.random.default_rng(1).standard_normal(
        (2, cfg.num_ws, 512)).astype(np.float32)
    jfn = jax.jit(lambda dt: jnets.backbone_apply(
        jp["backbone"], cfg.backbone, jnp.asarray(ws), compute_dtype=dt),
        static_argnums=0)
    out = {}
    for dt in (torch.float32, BF16):
        with torch.no_grad():
            planes = tnets.backbone_apply(tp["backbone"],
                                          torch_small_config().backbone,
                                          _t(ws), compute_dtype=dt)
        assert planes.dtype == torch.float32
        out[dt] = planes.permute(0, 2, 3, 1).numpy()
    j16 = jfn(jnp.bfloat16)
    assert j16.dtype == jnp.float32
    _hold_bf16(out[BF16], out[torch.float32], j16, jfn(jnp.float32), 2.5e-2)


@pytest.mark.parametrize("feature_res", [16, 8])
def test_superresolution_bf16_matches_jax(gen_params, feature_res):
    """16²: the SR input resolution; 8²: the bilinear pre-resize first."""
    cfg, jp, tp = gen_params
    rng = np.random.default_rng(feature_res)
    feats = rng.standard_normal((2, feature_res, feature_res, 32)) \
        .astype(np.float32)
    ws = rng.standard_normal((2, cfg.num_ws, 512)).astype(np.float32)
    jfn = jax.jit(lambda dt: jnets.superresolution_apply(
        jp["superresolution"], cfg.sr, jnp.asarray(feats[..., :3]),
        jnp.asarray(feats), jnp.asarray(ws), compute_dtype=dt),
        static_argnums=0)
    x = _t(feats).permute(0, 3, 1, 2)
    out = {}
    for dt in (torch.float32, BF16):
        with torch.no_grad():
            img = tnets.superresolution_apply(
                tp["superresolution"], torch_small_config().sr, x[:, :3], x,
                _t(ws), compute_dtype=dt)
        assert img.shape == (2, 3, 64, 64) and img.dtype == torch.float32
        out[dt] = img.permute(0, 2, 3, 1).numpy()
    _hold_bf16(out[BF16], out[torch.float32], jfn(jnp.bfloat16),
               jfn(jnp.float32), 2.5e-2)


@pytest.mark.parametrize("src", [16, 12, 5])
@pytest.mark.parametrize("antialias", [True, False])
def test_bilinear_resize_matches_jax(src, antialias):
    """The SR pre-resize, up to 32², fp32: 1e-5."""
    x = np.random.default_rng(src).standard_normal(
        (2, src, src, 5)).astype(np.float32)
    want = jnets._bilinear_resize(jnp.asarray(x), 32, antialias)
    got = tnets.bilinear_resize(_t(x).permute(0, 3, 1, 2), 32, antialias)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def test_decoder_bf16_matches_jax():
    """Features cast to bf16 after the plane mean, the 33 outputs back to
    fp32 before the sigmoid, in both."""
    cfg = small_config().render
    dp = jax.tree.map(np.asarray,
                      jrnd.init_decoder(jax.random.PRNGKey(0), cfg, 32))
    feats = np.random.default_rng(6).standard_normal(
        (2, 3, 400, 32)).astype(np.float32)
    tdp = convert.from_jax(dp)
    out = {}
    for name, dtype, jdtype in (("32", torch.float32, jnp.float32),
                                ("16", BF16, jnp.bfloat16)):
        want = jrnd.decoder_apply(dp, dataclasses.replace(
            cfg, decoder_dtype=jdtype), jnp.asarray(feats))
        got = trnd.decoder_apply(tdp, dataclasses.replace(
            torch_small_config().render, decoder_dtype=dtype),
            _t(feats).mean(1))
        assert all(g.dtype == torch.float32 for g in got)
        out[name] = (np.concatenate([g.numpy() for g in got], -1),
                     np.concatenate([np.asarray(w) for w in want], -1))
    _hold_bf16(out["16"][0], out["32"][0], out["16"][1], out["32"][1], 1e-2)


def _chunked(cfg, chunk, remat=False):
    return dataclasses.replace(cfg, ray_chunk=chunk, remat=remat)


@pytest.mark.parametrize("chunk", [64, 8])
def test_render_rays_ray_chunk_matches_jax(chunk):
    """JAX's chunked exact path (lax.map of its core, global placement);
    64 rays are 4 whole rows of the 16² image (the sampler keeps the
    grid), 8 rays half a row (no grid). The port's chunked render also
    equals its unchunked one to 1e-6: no depth clip binds here."""
    planes, dp, o, d = _render_inputs()
    jcfg = dataclasses.replace(small_config().render, ray_chunk=chunk)
    want = jrnd.render_rays(dp, jcfg, jnp.asarray(planes), jnp.asarray(o),
                            jnp.asarray(d))
    tcfg = torch_small_config("global").render
    tdp = convert.from_jax(dp)
    got = trnd.render_rays(tdp, _chunked(tcfg, chunk), _t(planes), _t(o),
                           _t(d), ray_grid=(16, 16))
    whole = trnd.render_rays(tdp, tcfg, _t(planes), _t(o), _t(d))
    for g_, w_, u_ in zip(got, want, whole):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-4,
                                   atol=1e-4)
        torch.testing.assert_close(g_, u_, rtol=1e-6, atol=1e-6)


def test_render_rays_ray_chunk_clips_depth_per_chunk():
    """Rays that hit nothing composite a depth of 0, which the clip lifts
    to the least depth of its call. With jittered depths that least depth
    differs from chunk to chunk: chunked, each ray's depth is its chunk's
    least depth, as in JAX's `lax.map`; unchunked, the batch's. Everything
    else equals the unchunked render to 1e-6 (the jitter is drawn once for
    the whole batch)."""
    planes, dp, o, d = _render_inputs()
    dp["fc1"]["bias"] = dp["fc1"]["bias"].copy()
    dp["fc1"]["bias"][0] = -1e4                  # σ → softplus(σ − 1) = 0
    tcfg = torch_small_config("stratified").render
    tdp = convert.from_jax(dp)
    chunk = 64

    def render(cfg):
        g = torch.Generator().manual_seed(3)
        return trnd.render_rays(tdp, cfg, _t(planes), _t(o), _t(d),
                                generator=g)

    got, whole = render(_chunked(tcfg, chunk)), render(tcfg)
    torch.testing.assert_close(got[0], whole[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[2], whole[2], rtol=0, atol=0)
    assert float(whole[2].max()) == 0.0
    # the coarse depths' least value of each chunk (fine depths lie above)
    jitter = torch.rand((2, 256, tcfg.depth_resolution, 1),
                        generator=torch.Generator().manual_seed(3))
    delta = (tcfg.ray_end - tcfg.ray_start) / (tcfg.depth_resolution - 1)
    least = tcfg.ray_start + jitter[:, :, 0, 0] * delta       # (2, 256)
    want = least.reshape(2, -1, chunk).amin(dim=(0, 2))
    torch.testing.assert_close(got[1][..., 0].reshape(2, -1, chunk),
                               want[None, :, None].expand(2, -1, chunk))
    torch.testing.assert_close(whole[1], torch.full_like(whole[1],
                                                         float(least.min())))
    assert len(set(want.tolist())) == 256 // chunk


@pytest.mark.parametrize("chunk", [None, 64])
def test_render_rays_remat_changes_nothing(chunk, monkeypatch):
    """remat recomputes the point evaluations in the backward: values and
    gradients equal the plain render bit for bit; the sampler runs twice
    more a call (each pass's evaluation again), and chunked the whole
    chunk (both passes) again."""
    planes, dp, o, d = _render_inputs(8)
    cots = [torch.from_numpy(np.random.default_rng(8).standard_normal(s)
                             .astype(np.float32))
            for s in ((2, 256, 32), (2, 256, 1), (2, 256, 1))]
    tcfg = _chunked(torch_small_config("stratified").render, chunk)
    calls = []
    sample_mean = trnd.triplane.sample_mean

    def spy(*a, **kw):
        calls.append(kw.get("layout"))
        return sample_mean(*a, **kw)

    monkeypatch.setattr(trnd.triplane, "sample_mean", spy)
    out = {}
    for remat in (False, True):
        calls.clear()
        tdp = convert.from_jax(dp).requires_grad_(True)
        tplanes = _t(planes).requires_grad_(True)
        outs = trnd.render_rays(tdp, dataclasses.replace(tcfg, remat=remat),
                                tplanes, _t(o), _t(d),
                                generator=torch.Generator().manual_seed(1),
                                ray_grid=(16, 16))
        loss = sum((x * g).sum() for x, g in zip(outs, cots))
        n_forward = len(calls)
        grads = torch.autograd.grad(loss, [tplanes, *tdp.parameters()])
        out[remat] = (outs, grads, n_forward, len(calls))
    n_chunks = 1 if chunk is None else 256 // chunk
    assert out[False][2:] == (2 * n_chunks, 2 * n_chunks)
    assert out[True][2:] == (2 * n_chunks, 4 * n_chunks)
    for a, b in zip(out[True][0] + out[True][1],
                    out[False][0] + out[False][1]):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=0, atol=0)


def test_render_rays_raises_when_ray_chunk_does_not_divide():
    planes, dp, o, d = _render_inputs()
    cfg = _chunked(torch_small_config().render, 100)
    with pytest.raises(ValueError, match="ray_chunk"):
        trnd.render_rays(convert.from_jax(dp), cfg, _t(planes), _t(o), _t(d))


def test_synthesis_bf16_matches_jax(gen_params):
    """The whole EG3D synthesis (exact path, global placement): image,
    raw image and depth, each in L2."""
    from hfa_gp_tpu.core import camera as jcam
    cfg, jp, tp = gen_params
    ws = np.random.default_rng(1).standard_normal(
        (2, cfg.num_ws, 512)).astype(np.float32)
    c = np.concatenate([np.asarray(jcam.flip_yz_label(jcam.sample_camera_label(
        None, horizontal_mean=1.5 + 0.1 * i, mode=None))) for i in range(2)])
    res = {}
    for name, jcfg in (("j32", cfg), ("j16", _jax16(cfg))):
        res[name] = jax.jit(lambda w, c_, jc=jcfg: jgen.synthesis(
            jp, jc, w, c_))(jnp.asarray(ws), jnp.asarray(c))
    tcfg = torch_small_config("global")
    for name, cfg_ in (("t32", tcfg), ("t16", _torch16(tcfg))):
        with torch.no_grad():
            res[name] = tgen.synthesis(tp, cfg_, _t(ws), _t(c))
    for key in ("image", "image_raw", "image_depth"):
        assert res["t16"][key].dtype == torch.float32
        _hold_bf16(*(_f32(res[n][key]) for n in ("t16", "t32", "j16", "j32")),
                   2.5e-2)


GROUPS = ("encoder", "subspace", "generator.backbone", "generator.decoder",
          "generator.superresolution")


def rgb_step_gaps() -> tuple[dict, dict]:
    """One `train.rgb.loss_fn` and its gradients at JCFG's widths: JAX's
    bf16 step ("j16") and the port's fp32 and bf16 steps ("t32", "t16")
    on the same params and batch → ({step: loss}, {group: {"t16-t32",
    "t16-j16", "j16-t32": L2 gap of the group's gradients}})."""
    from hfa_gp_tpu.core import camera as jcam
    jp = numpy_tree(jax.jit(lambda k: jheads.init_avatar_rgb(k, JCFG))(
        jax.random.PRNGKey(0)), np.random.default_rng(0))
    jlp = jax.tree.map(np.asarray,
                       jax.jit(jlpips.init_lpips)(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    image = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    label = np.concatenate([np.asarray(jcam.flip_yz_label(
        jcam.sample_camera_label(None, horizontal_mean=h, mode=None)))
        for h in (1.45, 1.7)])
    cfg = dataclasses.replace(JCFG, eg3d=_jax16(JCFG.eg3d))
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p, lp, x, c: jrgb.loss_fn(p, lp, cfg, x, c), has_aux=True))(
            jp, jlp, jnp.asarray(image), jnp.asarray(label))
    losses = {"j16": float(loss)}
    grads = {"j16": dict(_leaves(convert.convert_tree(
        jax.tree.map(np.asarray, g))))}
    for name, dtype in (("t32", torch.float32), ("t16", BF16)):
        tp = convert.from_jax(jp).requires_grad_(True)
        loss, aux = trgb.loss_fn(tp, convert.from_jax(jlp),
                                 common.with_dtype(TCFG, dtype), _t(image),
                                 _t(label))
        assert aux["generated"].dtype == torch.float32
        loss.backward()
        losses[name] = float(loss.detach())
        grads[name] = {n: np.zeros(tuple(p.shape), np.float32)
                       if p.grad is None else p.grad.numpy()
                       for n, p in tp.named_parameters()}
    gaps = {}
    for top in GROUPS:
        names = [n for n in grads["j16"] if n.startswith(top)]
        flat = {k: np.concatenate([grads[k][n].ravel() for n in names])
                for k in grads}
        gaps[top] = {"t16-t32": _l2(flat["t16"], flat["t32"]),
                     "t16-j16": _l2(flat["t16"], flat["j16"]),
                     "j16-t32": _l2(flat["j16"], flat["t32"])}
    return losses, gaps


def test_rgb_loss_and_gradients_bf16_match_jax():
    """One `train.rgb.loss_fn` in bf16 (image, LPIPS and loss fp32) against
    JAX's bf16 step and the port's fp32 step: the loss to 2e-3, each
    group's gradients as the module's docstring says. `python -m
    tests.test_torch_bf16` prints the readings."""
    losses, gaps = rgb_step_gaps()
    for other in ("j16", "t32"):
        assert abs(losses["t16"] - losses[other]) <= 2e-3 * abs(losses[other])
    for top, gap in gaps.items():
        assert 1e-4 < gap["t16-t32"] <= 3e-2, (top, gap)
        assert gap["t16-j16"] <= 2 * gap["j16-t32"], (top, gap)


if __name__ == "__main__":
    losses, gaps = rgb_step_gaps()
    print("losses", losses)
    for top, gap in gaps.items():
        print(f"{top:28s} " + "  ".join(f"{k} {v:.4f}"
                                          for k, v in gap.items()))
