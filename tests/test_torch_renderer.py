"""The port's renderer (models/eg3d/renderer.py) against the JAX package's,
at tests/test_eg3d.py's small_config widths.

Which JAX path each case is held to:
  * sampler_fine="global" — JAX's exact path (use_pallas_sampler=False,
    fp32 row gathers, global-quantile fine placement);
  * sampler_fine="stratified" — JAX's chip path (the windowed Pallas
    sampler in interpret mode, fp32 slab covering the whole plane, so
    its bilinear lookup is exact).
Tolerance: 1e-5 for the sampling maths (fp32 cumsum/searchsorted in
another order); 1e-4 for whole renders (two decoder passes and two
marches over fp32 features).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfa_gp_tpu.core import camera as jcam
from hfa_gp_tpu.models.eg3d import renderer as jrnd
from hfa_gp_tpu_torch.models.eg3d import renderer as trnd
from hfa_gp_tpu_torch.utils import convert
from tests.test_eg3d import small_config
from tests.test_torch_networks import torch_small_config

# One intra-op thread: the suite runs several worker processes side by
# side, and a thread pool per worker as wide as the machine makes them wait
# on each other (the port's CPU tests: 468 s with the default, 216 s so).
torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _coarse_weights(seed, nr=50, n=12):
    rng = np.random.default_rng(seed)
    z = np.broadcast_to(np.linspace(2.25, 3.3, n, dtype=np.float32),
                        (nr, n)).copy()
    w = rng.exponential(0.2, (nr, n - 1)).astype(np.float32)
    w[:5] = 0.0                                  # empty rays
    w[5:10, 3] = 5.0                             # one sharp surface
    return z, w


def test_smooth_weights():
    _, w = _coarse_weights(0)
    np.testing.assert_allclose(
        trnd._smooth_weights(_t(w)).numpy(),
        np.asarray(jrnd._smooth_weights(jnp.asarray(w))), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("u_kind", ["linspace", "random", "edges"])
def test_sample_pdf(u_kind):
    z, w = _coarse_weights(1)
    bins = 0.5 * (z[:, :-1] + z[:, 1:])
    rng = np.random.default_rng(1)
    u = None
    if u_kind == "random":
        u = rng.uniform(0, 1, (z.shape[0], 16)).astype(np.float32)
    elif u_kind == "edges":                      # u = 0 and u = 1 exactly
        u = np.tile(np.array([0.0, 1.0, 0.5, 1.0], np.float32),
                    (z.shape[0], 4))
    want = jrnd.sample_pdf(jnp.asarray(bins), jnp.asarray(w[:, 1:-1]), 16,
                           u=None if u is None else jnp.asarray(u))
    got = trnd.sample_pdf(_t(bins), _t(w[:, 1:-1]), 16,
                          u=None if u is None else _t(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_eval_cdf():
    rng = np.random.default_rng(2)
    bins = np.sort(rng.uniform(2.2, 3.4, (30, 9)).astype(np.float32), axis=1)
    cdf = np.sort(rng.uniform(0, 1, (30, 9)).astype(np.float32), axis=1)
    x = rng.uniform(2.0, 3.6, (30, 7)).astype(np.float32)  # outside too
    np.testing.assert_allclose(
        trnd._eval_cdf(_t(bins), _t(cdf), _t(x)).numpy(),
        np.asarray(jrnd._eval_cdf(jnp.asarray(bins), jnp.asarray(cdf),
                                  jnp.asarray(x))), rtol=1e-5, atol=1e-6)


def test_sample_importance_and_windowed():
    z, w = _coarse_weights(3, nr=2 * 25)
    zv = z.reshape(2, 25, -1, 1)
    wv = w.reshape(2, 25, -1, 1)
    want = jrnd.sample_importance(jnp.asarray(zv), jnp.asarray(wv), 12)
    got = trnd.sample_importance(_t(zv), _t(wv), 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    want = jrnd.sample_importance_windowed(
        jnp.asarray(zv), jnp.asarray(wv), n_windows=3, n_per=4,
        ray_start=2.25, ray_end=3.3)
    got = trnd.sample_importance_windowed(_t(zv), _t(wv), n_windows=3,
                                          n_per=4, ray_start=2.25,
                                          ray_end=3.3)
    assert got.shape == (2, 25, 12, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert bool((got[..., 1:, 0] >= got[..., :-1, 0]).all())


def test_random_placements_are_sorted_and_in_range():
    """Uniform draws (from a seeded generator, as `render_rays` draws them
    up front) place the samples sorted and inside the ray's range."""
    z, w = _coarse_weights(4, nr=2 * 25)
    zv, wv = _t(z.reshape(2, 25, -1, 1)), _t(w.reshape(2, 25, -1, 1))
    g = torch.Generator().manual_seed(0)
    for fine in (trnd.sample_importance(zv, wv, 12,
                                        u=torch.rand((50, 12), generator=g)),
                 trnd.sample_importance_windowed(
                     zv, wv, 3, 4, 2.25, 3.3,
                     jitter=torch.rand((50, 3, 4), generator=g))):
        assert bool((fine[..., 1:, 0] >= fine[..., :-1, 0]).all())
        assert float(fine.min()) >= 2.25 and float(fine.max()) <= 3.3
    d = trnd.sample_stratified(torch.zeros(2, 5, 3), 2.25, 3.3, 8,
                               jitter=torch.rand((2, 5, 8, 1), generator=g))
    base = torch.linspace(2.25, 3.3, 8)[None, None, :, None]
    assert bool(((d - base) >= 0).all() and ((d - base) <= 0.15 + 1e-6).all())


def test_unify_samples_ties_keep_list_one_first():
    rng = np.random.default_rng(5)
    d1 = np.sort(rng.uniform(2, 3, (2, 6, 5, 1)).astype(np.float32), axis=2)
    d2 = np.sort(rng.uniform(2, 3, (2, 6, 4, 1)).astype(np.float32), axis=2)
    d2[:, :, 1] = d1[:, :, 2]                    # exact ties across lists
    d2[:, :, 2] = d1[:, :, 2]
    d2 = np.sort(d2, axis=2)                     # the merge needs sorted lists
    c1, c2 = (rng.standard_normal(s).astype(np.float32)
              for s in ((2, 6, 5, 3), (2, 6, 4, 3)))
    s1, s2 = (rng.standard_normal(s).astype(np.float32)
              for s in ((2, 6, 5, 1), (2, 6, 4, 1)))
    want = jrnd.unify_samples(*(jnp.asarray(a) for a in
                                (d1, c1, s1, d2, c2, s2)),
                              sorted_inputs=True)
    got = trnd.unify_samples(*(_t(a) for a in (d1, c1, s1, d2, c2, s2)))
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


def test_decoder_matches_jax():
    cfg = small_config().render
    dp = jax.tree.map(np.asarray,
                      jrnd.init_decoder(jax.random.PRNGKey(0), cfg, 32))
    feats = np.random.default_rng(6).standard_normal(
        (2, 3, 40, 32)).astype(np.float32)
    want = jrnd.decoder_apply(dp, cfg, jnp.asarray(feats))
    got = trnd.decoder_apply(convert.from_jax(dp), torch_small_config().render,
                             _t(feats).mean(1))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-5)


def _render_inputs(seed=7, b=2, res=16, hw=32):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    planes = np.array(jax.random.normal(k1, (b, 3, hw, hw, 32)))
    dp = jax.tree.map(np.asarray,
                      jrnd.init_decoder(k2, small_config().render, 32))
    lab = np.asarray(jcam.flip_yz_label(jcam.sample_camera_label(
        None, n=b, horizontal_mean=1.75, mode=None)))
    c2w, intr = jcam.unpack_label(jnp.asarray(lab))
    o, d = jcam.generate_rays(c2w, intr, res)
    return planes, dp, np.array(o), np.array(d)


@pytest.mark.parametrize("fine", ["global", "stratified", "none"])
def test_render_rays_matches_jax(fine):
    planes, dp, o, d = _render_inputs()
    jcfg = small_config().render
    tcfg = torch_small_config("stratified" if fine == "none" else fine)\
        .render
    if fine == "stratified":
        jcfg = dataclasses.replace(
            jcfg, use_pallas_sampler=True, pallas_interpret=True,
            sampler_dtype=jnp.float32, sampler_tile=8,
            sampler_slab=(32, 40))       # fp32: effective (32, 32) = plane
    elif fine == "none":
        jcfg = dataclasses.replace(jcfg, depth_resolution_importance=0)
        tcfg = dataclasses.replace(tcfg, depth_resolution_importance=0)
    want = jrnd.render_rays(dp, jcfg, jnp.asarray(planes), jnp.asarray(o),
                            jnp.asarray(d))
    got = trnd.render_rays(convert.from_jax(dp), tcfg, _t(planes), _t(o),
                           _t(d))
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-4,
                                   atol=1e-4)
    assert float(np.asarray(want[2]).max()) > 0.1     # rays hit something


def test_render_rays_passes_the_ray_grid_and_changes_nothing(monkeypatch):
    """`ray_grid` reaches the sampler as the layout (res, res, n) of each
    pass and, on the CPU, gives exactly the result without it."""
    planes, dp, o, d = _render_inputs()
    tcfg = torch_small_config("stratified").render
    want = trnd.render_rays(convert.from_jax(dp), tcfg, _t(planes), _t(o),
                            _t(d))
    seen = []
    sample_mean = trnd.triplane.sample_mean

    def spy(*a, **kw):
        seen.append(kw.get("layout"))
        return sample_mean(*a, **kw)

    monkeypatch.setattr(trnd.triplane, "sample_mean", spy)
    got = trnd.render_rays(convert.from_jax(dp), tcfg, _t(planes), _t(o),
                           _t(d), ray_grid=(16, 16))
    assert seen == [(16, 16, tcfg.depth_resolution),
                    (16, 16, tcfg.depth_resolution_importance)]
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=0, atol=0)


@pytest.mark.parametrize("fine", ["global", "stratified"])
def test_render_rays_gradients_match_jax(fine):
    """d(scalar of all three outputs)/d(planes, decoder params) against
    jax.grad of the JAX render_rays: the exact fp32 path for "global", the
    windowed sampler's custom VJP (interpret mode, fp32 whole-plane slab)
    for "stratified". The fine depths carry no gradient (JAX:
    stop_gradient); without the detach in the port the coarse densities
    would get one through the fine sample coordinates. Bound: 1e-4 × each
    gradient's scale."""
    planes, dp, o, d = _render_inputs(8)
    rng = np.random.default_rng(8)
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((2, 256, 32), (2, 256, 1), (2, 256, 1))]
    jcfg = small_config().render
    if fine == "stratified":
        jcfg = dataclasses.replace(
            jcfg, use_pallas_sampler=True, pallas_interpret=True,
            sampler_dtype=jnp.float32, sampler_tile=8, sampler_slab=(32, 40))

    def jloss(p, dec):
        outs = jrnd.render_rays(dec, jcfg, p, jnp.asarray(o), jnp.asarray(d))
        return sum(jnp.sum(out * g) for out, g in zip(outs, cots))

    want_p, want_d = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(planes), dp)

    tdp = convert.from_jax(dp).requires_grad_(True)
    tplanes = _t(planes).requires_grad_(True)
    outs = trnd.render_rays(tdp, torch_small_config(fine).render, tplanes,
                            _t(o), _t(d))
    loss = sum((out * _t(g)).sum() for out, g in zip(outs, cots))
    names = [n for n, _ in tdp.named_parameters()]
    grads = torch.autograd.grad(loss, [tplanes, *tdp.parameters()])

    def close(got, want):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * scale)

    close(grads[0], want_p)
    for name, got in zip(names, grads[1:]):
        layer, leaf = name.split(".")
        close(got, want_d[layer][leaf])
