"""The port's two kernel modules (core/kernels/{triplane,raymarch}.py):
their plain versions, forward and backward, against the JAX package, the
dispatch of the wrappers, and (marked `gpu`, card only) each CUDA kernel
against its plain version.

Tolerances: the sampler is an fp32 bilinear lookup whose texel coordinate
is computed in another rounding order than JAX's ((u+1)·W−1)/2 vs
(u+1)·(W/2)−0.5), 1e-5 on unit-normal planes. The marcher uses the JAX
package's own kernel test bound, rtol 1e-4 / atol 1e-5. Gradients are held
to 1e-4 × the gradient's scale (max abs): a plane texel or a density sums
many fp32 contributions in another order. On the card the sampler's
backward kernel sums with atomics, whose order changes from run to run,
which the same bound covers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfa_gp_tpu.core.pallas import triplane as jtp
from hfa_gp_tpu.core.pallas.raymarch import pallas_ray_march
from hfa_gp_tpu.models.eg3d import renderer as jrnd
from hfa_gp_tpu_torch.core.kernels import raymarch, triplane

# One intra-op thread: the suite runs several worker processes side by
# side, and a thread pool per worker as wide as the machine makes them wait
# on each other (the port's CPU tests: 468 s with the default, 216 s so).
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _planes_and_points(seed=0, b=2, hw=24, c=32, m=300):
    rng = np.random.default_rng(seed)
    planes = rng.standard_normal((b, 3, hw, hw + 4, c)).astype(np.float32)
    # most points inside the box, some leaving it (zeros padding)
    pts = rng.uniform(-0.75, 0.75, (b, m, 3)).astype(np.float32)
    return planes, pts


@pytest.mark.parametrize("box_warp", [1.0, 1.6])
def test_sampler_plain_matches_jax_sample_from_planes(box_warp):
    planes, pts = _planes_and_points()
    want = np.asarray(jrnd.sample_from_planes(
        jnp.asarray(planes), jnp.asarray(pts), box_warp).mean(1))
    got = triplane.sample_mean_plain(torch.from_numpy(planes),
                                     torch.from_numpy(pts), box_warp)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert float(np.abs(want).mean()) > 0.1


def test_sampler_plain_per_plane_matches_jax():
    planes, pts = _planes_and_points(1)
    want = np.asarray(jrnd.sample_from_planes(jnp.asarray(planes),
                                              jnp.asarray(pts), 1.0))
    got = triplane.sample_from_planes(torch.from_numpy(planes),
                                      torch.from_numpy(pts), 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_sampler_plain_matches_jax_windowed_kernel():
    """The TPU kernel itself (interpret mode, fp32, a slab that covers the
    whole 32² plane, so no footprint can overflow it)."""
    res, n_depth, hw, c, b = 16, 8, 32, 32, 2
    kp, kc = jax.random.split(jax.random.PRNGKey(3))
    planes = np.array(jax.random.normal(kp, (b, 3, hw, hw, c)))
    coords = np.array(_ray_grid_coords(kc, res, n_depth, b=b))
    want = np.asarray(jtp.sample_from_planes_windowed(
        jnp.asarray(planes), jnp.asarray(coords), 1.0, jrnd._PLANE_INV,
        res=res, n_depth=n_depth, tile=8, depth_window=4, slab=(hw, hw),
        dtype=jnp.float32, interpret=True).mean(1))
    got = triplane.sample_mean_plain(torch.from_numpy(planes),
                                     torch.from_numpy(coords), 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert float(np.abs(want).mean()) > 0.1


def _ray_grid_coords(key, res, n_depth, spread=0.25, b=1):
    """A tile-coherent bundle of rays through the unit box (the geometry
    of tests/test_pallas_triplane.py), so the windowed kernel's block
    footprints stay small."""
    korg, _ = jax.random.split(key)
    origin = np.array([0.0, 0.0, -2.7], np.float32) + 0.05 * np.asarray(
        jax.random.normal(korg, (b, 1, 3)))
    i = (np.arange(res, dtype=np.float32) + 0.5) / res - 0.5
    yy, xx = np.meshgrid(i, i, indexing="ij")
    dirs = np.stack([xx * spread, yy * spread, np.ones_like(xx)], -1)
    dirs = dirs.reshape(1, -1, 3)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    depths = np.linspace(2.25, 3.3, n_depth, dtype=np.float32)
    pts = origin[:, :, None, :] + depths[None, None, :, None] \
        * dirs[:, :, None, :]
    return pts.reshape(b, -1, 3).astype(np.float32)


def _march_inputs(seed=0, b=2, r=37, n=16, c=32):
    rng = np.random.default_rng(seed)
    colors = rng.standard_normal((b, r, n, c)).astype(np.float32)
    densities = rng.standard_normal((b, r, n, 1)).astype(np.float32)
    depths = np.sort(rng.uniform(2.25, 3.3, (b, r, n, 1)).astype(np.float32),
                     axis=2)
    return colors, densities, depths


def _assert_march_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("white_back", [False, True])
def test_marcher_plain_matches_jax_ray_march(white_back):
    colors, densities, depths = _march_inputs()
    cfg = jrnd.RenderConfig(white_back=white_back)
    want = jrnd.ray_march(jnp.asarray(colors), jnp.asarray(densities),
                          jnp.asarray(depths), cfg)
    got = raymarch.ray_march_plain(torch.from_numpy(colors),
                                   torch.from_numpy(densities),
                                   torch.from_numpy(depths),
                                   white_back=white_back)
    _assert_march_close([t.numpy() for t in got], want)


def test_marcher_plain_matches_jax_pallas_kernel():
    colors, densities, depths = _march_inputs(1)
    want = pallas_ray_march(jnp.asarray(colors), jnp.asarray(densities),
                            jnp.asarray(depths), interpret=True)
    got = raymarch.ray_march_plain(torch.from_numpy(colors),
                                   torch.from_numpy(densities),
                                   torch.from_numpy(depths))
    _assert_march_close([t.numpy() for t in got], want)


def test_wrappers_route_cpu_tensors_to_plain_versions():
    planes, pts = (torch.from_numpy(a) for a in _planes_and_points(2))
    n_s, n_m = triplane.LAUNCHES, raymarch.LAUNCHES
    torch.testing.assert_close(triplane.sample_mean(planes, pts, 1.0),
                               triplane.sample_mean_plain(planes, pts, 1.0),
                               rtol=0, atol=0)
    colors, dens, depths = (torch.from_numpy(a) for a in _march_inputs(2))
    for got, want in zip(raymarch.ray_march(colors, dens, depths),
                         raymarch.ray_march_plain(colors, dens, depths)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # CPU calls launch nothing
    assert (triplane.LAUNCHES, raymarch.LAUNCHES) == (n_s, n_m)


def test_wrappers_raise_on_other_devices():
    """Neither wrapper has a fallback: a device that is neither the CPU
    nor CUDA raises."""
    planes, pts = (torch.from_numpy(a).to("meta")
                   for a in _planes_and_points(3))
    with pytest.raises(ValueError):
        triplane.sample_mean(planes, pts, 1.0)
    colors, dens, depths = (torch.from_numpy(a).to("meta")
                            for a in _march_inputs(3))
    with pytest.raises(ValueError):
        raymarch.ray_march(colors, dens, depths)


def _assert_grad_close(got, want, rel=1e-4):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * scale)


@pytest.mark.parametrize("box_warp", [1.0, 1.6])
def test_sampler_backward_plain_matches_jax_grad(box_warp):
    planes, pts = _planes_and_points(7)
    g = np.random.default_rng(7).standard_normal(
        (planes.shape[0], pts.shape[1], planes.shape[-1])).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(jrnd.sample_from_planes(
        p, jnp.asarray(pts), box_warp).mean(1) * g))(jnp.asarray(planes))
    got = triplane.sample_mean_backward_plain(
        torch.from_numpy(g), planes.shape, torch.from_numpy(pts), box_warp)
    assert got.shape == planes.shape
    _assert_grad_close(got.numpy(), want)


def test_sampler_backward_plain_matches_jax_windowed_vjp():
    """The TPU backward kernel itself: the custom VJP of the windowed
    sampler in interpret mode, fp32, a slab that covers the whole plane."""
    res, n_depth, hw, c, b = 16, 8, 32, 32, 1
    kp, kc = jax.random.split(jax.random.PRNGKey(4))
    planes = np.array(jax.random.normal(kp, (b, 3, hw, hw, c)))
    coords = np.array(_ray_grid_coords(kc, res, n_depth, b=b))
    g = np.random.default_rng(8).standard_normal(
        (b, coords.shape[1], c)).astype(np.float32)

    def loss(p):
        f = jtp.sample_from_planes_windowed(
            p, jnp.asarray(coords), 1.0, jrnd._PLANE_INV, res=res,
            n_depth=n_depth, tile=8, depth_window=4, slab=(hw, hw),
            dtype=jnp.float32, interpret=True)
        return jnp.sum(f.mean(1) * g)

    want = jax.grad(loss)(jnp.asarray(planes))
    got = triplane.sample_mean_backward_plain(
        torch.from_numpy(g), planes.shape, torch.from_numpy(coords), 1.0)
    _assert_grad_close(got.numpy(), want)


def _march_cotangents(seed, b, r, n, c):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, r, c)).astype(np.float32),
            rng.standard_normal((b, r, 1)).astype(np.float32),
            rng.standard_normal((b, r, n - 1, 1)).astype(np.float32))


@pytest.mark.parametrize("which", ["all", "rgb", "depth", "weights"])
def test_marcher_backward_plain_matches_jax_grad(which):
    colors, densities, depths = _march_inputs(8)
    cots = _march_cotangents(8, *colors.shape)
    used = [cot if which in ("all", name) else None
            for name, cot in zip(("rgb", "depth", "weights"), cots)]
    cfg = jrnd.RenderConfig()

    def loss(col, den):
        outs = jrnd.ray_march(col, den, jnp.asarray(depths), cfg)
        return sum(jnp.sum(o * g) for o, g in zip(outs, used)
                   if g is not None)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(colors),
                                          jnp.asarray(densities))
    got = raymarch.ray_march_backward_plain(
        *(torch.from_numpy(a) for a in (colors, densities, depths)),
        *(None if g is None else torch.from_numpy(g) for g in used))
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape
        if not np.abs(np.asarray(w_)).max():
            # depth and weights do not depend on the colours
            assert which in ("depth", "weights") and not g_.abs().max()
            continue
        _assert_grad_close(g_.numpy(), w_)


def test_backward_wrappers_route_cpu_tensors_to_plain_versions():
    planes, pts = (torch.from_numpy(a) for a in _planes_and_points(9))
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (planes.shape[0], pts.shape[1], planes.shape[-1])).astype(np.float32))
    n_s, n_m = triplane.LAUNCHES_BWD, raymarch.LAUNCHES_BWD
    torch.testing.assert_close(
        triplane.sample_mean_backward(g, planes.shape, pts, 1.0),
        triplane.sample_mean_backward_plain(g, planes.shape, pts, 1.0),
        rtol=0, atol=0)
    colors, dens, depths = (torch.from_numpy(a) for a in _march_inputs(9))
    cots = [torch.from_numpy(a) for a in _march_cotangents(9, *colors.shape)]
    for got, want in zip(
            raymarch.ray_march_backward(colors, dens, depths, *cots),
            raymarch.ray_march_backward_plain(colors, dens, depths, *cots)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (triplane.LAUNCHES_BWD, raymarch.LAUNCHES_BWD) == (n_s, n_m)
    with pytest.raises(ValueError):
        triplane.sample_mean_backward(g.to("meta"), planes.shape,
                                      pts.to("meta"), 1.0)
    with pytest.raises(ValueError):
        raymarch.ray_march_backward(colors.to("meta"), dens.to("meta"),
                                    depths.to("meta"))


def test_cpu_wrappers_are_differentiable_like_the_plain_versions():
    """On the CPU the wrappers are the plain versions, autograd included:
    the reference the card's autograd Functions are held to."""
    planes, pts = (torch.from_numpy(a) for a in _planes_and_points(10))
    planes.requires_grad_(True)
    g = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (planes.shape[0], pts.shape[1], planes.shape[-1])).astype(np.float32))
    (got,) = torch.autograd.grad(triplane.sample_mean(planes, pts, 1.0),
                                 planes, g)
    torch.testing.assert_close(
        got, triplane.sample_mean_backward_plain(g, planes.shape, pts, 1.0),
        rtol=0, atol=0)
    colors, dens, depths = (torch.from_numpy(a) for a in _march_inputs(10))
    colors.requires_grad_(True)
    dens.requires_grad_(True)
    cots = [torch.from_numpy(a) for a in _march_cotangents(10, *colors.shape)]
    got = torch.autograd.grad(raymarch.ray_march(colors, dens, depths),
                              [colors, dens], cots)
    want = raymarch.ray_march_backward_plain(colors, dens, depths, *cots)
    for g_, w_ in zip(got, want):
        _assert_grad_close(g_.numpy(), w_.numpy(), rel=1e-6)


def test_sampler_layout_is_checked_and_changes_nothing_on_the_cpu():
    """`layout` (h, w, n) only orders the backward kernel's sums: on the
    CPU both wrappers give exactly what they give without it, through
    autograd too, and raise on a layout that does not cover the points."""
    planes, pts = (torch.from_numpy(a) for a in _planes_and_points(15, m=60))
    g = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (2, 60, 32)).astype(np.float32))
    for layout in ((3, 4, 5), [1, 1, 60], (6, 10, 1)):
        torch.testing.assert_close(
            triplane.sample_mean(planes, pts, 1.0, layout),
            triplane.sample_mean(planes, pts, 1.0), rtol=0, atol=0)
        torch.testing.assert_close(
            triplane.sample_mean_backward(g, planes.shape, pts, 1.0, layout),
            triplane.sample_mean_backward(g, planes.shape, pts, 1.0),
            rtol=0, atol=0)
    leaf = planes.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(
        triplane.sample_mean(leaf, pts, 1.0, (3, 4, 5)), leaf, g)
    torch.testing.assert_close(
        got, triplane.sample_mean_backward_plain(g, planes.shape, pts, 1.0),
        rtol=0, atol=0)
    for bad in ((3, 4, 4), (60, 1), (0, 60, 1), (-1, -6, 10), "abc", 60):
        with pytest.raises(ValueError):
            triplane.sample_mean(planes, pts, 1.0, bad)
        with pytest.raises(ValueError):
            triplane.sample_mean_backward(g, planes.shape, pts, 1.0, bad)


# -- on the card -------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("c,m", [(32, 1000), (40, 77), (8, 5)])
def test_sampler_kernel_matches_plain(cuda, c, m):
    planes, pts = _planes_and_points(4, c=c, m=m)
    planes, pts = torch.from_numpy(planes).to(cuda), \
        torch.from_numpy(pts).to(cuda)
    n = triplane.LAUNCHES
    got = triplane.sample_mean(planes, pts, 1.0)
    torch.cuda.synchronize()
    assert triplane.LAUNCHES == n + 1
    torch.testing.assert_close(got, triplane.sample_mean_plain(planes, pts,
                                                               1.0),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("spread", [1.0, 3.0])
@pytest.mark.parametrize("c", [8, 32, 48, 30])
def test_sampler_kernel_lane_layouts_match_plain(cuda, c, spread):
    """16-byte lanes at 2, 8 and 16 lanes a point (C 8, 32, 48) and one
    float a lane (C 30), on non-square planes, with most points off the
    planes at spread 3."""
    rng = np.random.default_rng(c)
    planes = torch.from_numpy(
        rng.standard_normal((3, 3, 20, 28, c)).astype(np.float32)).to(cuda)
    pts = torch.from_numpy(((rng.uniform(size=(3, 5000, 3)) - 0.5) * spread)
                           .astype(np.float32)).to(cuda)
    got = triplane.sample_mean(planes, pts, 1.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, triplane.sample_mean_plain(planes, pts,
                                                               1.0),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [8, 32, 48])
def test_sampler_kernel_never_reads_out_of_plane_corners(cuda, c):
    """Planes whose last row and column are NaN, points a fraction of a
    texel around the first row and column: an out-of-plane corner's address
    falls on a NaN texel of the row or plane before, and must contribute
    exactly 0."""
    rng = np.random.default_rng(c)
    planes = rng.standard_normal((2, 3, 16, 16, c)).astype(np.float32)
    planes[:, :, -1] = np.nan
    planes[:, :, :, -1] = np.nan
    pts = (-0.5 + rng.uniform(-0.5, 0.5, (2, 4096, 3)) / 16) \
        .astype(np.float32)
    planes, pts = torch.from_numpy(planes).to(cuda), \
        torch.from_numpy(pts).to(cuda)
    got = triplane.sample_mean(planes, pts, 1.0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, triplane.sample_mean_plain(planes, pts,
                                                               1.0),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("r,n,c", [(37, 16, 32), (5, 7, 35), (3, 2, 3)])
def test_marcher_kernel_matches_plain(cuda, r, n, c):
    colors, dens, depths = (torch.from_numpy(a).to(cuda)
                            for a in _march_inputs(5, r=r, n=n, c=c))
    n0 = raymarch.LAUNCHES
    got = raymarch.ray_march(colors, dens, depths)
    torch.cuda.synchronize()
    assert raymarch.LAUNCHES == n0 + 1
    for g, w in zip(got, raymarch.ray_march_plain(colors, dens, depths)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    planes, pts = (torch.from_numpy(a).to(cuda)
                   for a in _planes_and_points(6))
    with pytest.raises(ValueError):
        triplane.sample_mean(planes.double(), pts.double(), 1.0)
    with pytest.raises(ValueError):
        triplane.sample_mean(planes, pts.transpose(1, 2).contiguous()
                             .transpose(1, 2), 1.0)
    colors, dens, depths = (torch.from_numpy(a).to(cuda)
                            for a in _march_inputs(6))
    with pytest.raises(ValueError):
        raymarch.ray_march(colors, dens[..., :-1, :], depths)
    with pytest.raises(ValueError):
        raymarch.ray_march_backward(colors, dens, depths,
                                    torch.zeros(2, 37, 31, device=cuda))
    with pytest.raises(ValueError):
        raymarch.ray_march_backward(colors.double(), dens.double(),
                                    depths.double())


@pytest.mark.gpu
@pytest.mark.parametrize("c,m", [(32, 1000), (40, 77), (8, 5)])
def test_sampler_backward_kernel_matches_plain(cuda, c, m):
    planes, pts = _planes_and_points(11, c=c, m=m)
    pts = torch.from_numpy(pts).to(cuda)
    g = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (planes.shape[0], m, c)).astype(np.float32)).to(cuda)
    n = triplane.LAUNCHES_BWD
    got = triplane.sample_mean_backward(g, planes.shape, pts, 1.0)
    torch.cuda.synchronize()
    assert triplane.LAUNCHES_BWD == n + 1
    want = triplane.sample_mean_backward_plain(g, planes.shape, pts, 1.0)
    _assert_grad_close(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("r,n,c", [(37, 16, 32), (5, 7, 35), (3, 2, 3),
                                   (4, 1, 8)])
@pytest.mark.parametrize("which", ["all", "rgb", "weights"])
def test_marcher_backward_kernel_matches_plain(cuda, r, n, c, which):
    colors, dens, depths = (torch.from_numpy(a).to(cuda)
                            for a in _march_inputs(12, r=r, n=n, c=c))
    cots = [torch.from_numpy(a).to(cuda) if which in ("all", name) else None
            for name, a in zip(("rgb", "depth", "weights"),
                               _march_cotangents(12, 2, r, n, c))]
    n0 = raymarch.LAUNCHES_BWD
    got = raymarch.ray_march_backward(colors, dens, depths, *cots)
    torch.cuda.synchronize()
    assert raymarch.LAUNCHES_BWD == n0 + 1
    want = raymarch.ray_march_backward_plain(colors, dens, depths, *cots)
    for g_, w_ in zip(got, want):
        scale = max(float(w_.abs().max()), 1e-6)
        torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.gpu
def test_autograd_through_the_kernels_matches_plain(cuda):
    """A loss over sampler → marcher: autograd through the two Functions
    launches both backward kernels and gives the plain versions'
    gradients; under inference_mode the forward records nothing."""
    planes, pts = _planes_and_points(13, m=37 * 16)
    planes = torch.from_numpy(planes).to(cuda).requires_grad_(True)
    pts = torch.from_numpy(pts).to(cuda)
    _, dens, depths = (torch.from_numpy(a).to(cuda)
                       for a in _march_inputs(13))
    dens.requires_grad_(True)
    cots = [torch.from_numpy(a).to(cuda)
            for a in _march_cotangents(13, 2, 37, 16, 32)]

    def loss(sample, march):
        colors = sample(planes, pts, 1.0).reshape(2, 37, 16, 32)
        return sum((o * g).sum() for o, g in
                   zip(march(colors, dens, depths), cots))

    n_s, n_m = triplane.LAUNCHES_BWD, raymarch.LAUNCHES_BWD
    got = torch.autograd.grad(loss(triplane.sample_mean, raymarch.ray_march),
                              [planes, dens])
    torch.cuda.synchronize()
    assert (triplane.LAUNCHES_BWD, raymarch.LAUNCHES_BWD) == (n_s + 1,
                                                              n_m + 1)
    want = torch.autograd.grad(loss(triplane.sample_mean_plain,
                                    raymarch.ray_march_plain), [planes, dens])
    for g_, w_ in zip(got, want):
        _assert_grad_close(g_.cpu().numpy(), w_.cpu().numpy())
    with torch.inference_mode():
        out = triplane.sample_mean(planes, pts, 1.0)
    assert not out.requires_grad


@pytest.mark.gpu
def test_kernel_wrappers_refuse_gradients_they_cannot_give(cuda):
    planes, pts = (torch.from_numpy(a).to(cuda)
                   for a in _planes_and_points(14))
    with pytest.raises(ValueError):
        triplane.sample_mean(planes, pts.requires_grad_(True), 1.0)
    colors, dens, depths = (torch.from_numpy(a).to(cuda)
                            for a in _march_inputs(14))
    with pytest.raises(ValueError):
        raymarch.ray_march(colors, dens, depths.requires_grad_(True))
    with pytest.raises(ValueError):
        raymarch.ray_march_backward(
            colors, dens, depths.detach(),
            torch.zeros(colors.shape[:2], device=cuda))


def _camera_points(b, res, n, yaw=0.0, hw=256):
    """(b, res²·n, 3) points of res² rays from a camera turned `yaw` off
    the mean pose, n samples each between the renderer's bounds, laid out
    (res, res, n); planes (b, 3, hw, hw, ·) cover the unit box."""
    from hfa_gp_tpu_torch.core import camera
    label = camera.flip_yz_label(camera.sample_camera_label(
        None, mode=None, horizontal_mean=np.pi / 2 + yaw))
    c2w, intr = camera.unpack_label(label.repeat(b, 1))
    o, d = camera.generate_rays(c2w, intr, res)
    depths = torch.linspace(2.25, 3.3, n)[None, None, :, None]
    return (o[:, :, None] + depths * d[:, :, None]).reshape(b, -1, 3) \
        .contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", [True, False])
@pytest.mark.parametrize("c", [8, 30, 32, 48])
def test_sampler_backward_kernel_on_rays_matches_plain(cuda, c, layout):
    """Camera rays at batch 3 with tiles cut by the layout's edge (13 x 13
    rays of 7 samples), with the layout (the sorted path at C 8 and 32)
    and without it (the direct pass at C 30 and 48 either way)."""
    pts = _camera_points(3, 13, 7).to(cuda)
    shape = (3, 3, 64, 64, c)
    g = torch.from_numpy(np.random.default_rng(c).standard_normal(
        (3, pts.shape[1], c)).astype(np.float32)).to(cuda)
    n = triplane.LAUNCHES_BWD
    got = triplane.sample_mean_backward(g, shape, pts, 1.0,
                                        (13, 13, 7) if layout else None)
    torch.cuda.synchronize()
    assert triplane.LAUNCHES_BWD == n + 1
    want = triplane.sample_mean_backward_plain(g, shape, pts, 1.0)
    _assert_grad_close(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["grazing", "shuffled", "off-plane",
                                  "non-square"])
def test_sampler_backward_kernel_where_boxes_overflow(cuda, case):
    """Tiles whose boxes overflow the sorted path's buckets (a camera
    turned 1.3 rad at 256² planes; shuffled points under a layout that is
    not theirs), points mostly off the planes, and 48 x 40 planes."""
    pts = _camera_points(2, 48, 24, yaw=1.3 if case == "grazing" else 0.0)
    hw = (48, 40) if case == "non-square" else (256, 256)
    if case == "shuffled":
        pts = pts[:, torch.randperm(pts.shape[1],
                                    generator=torch.Generator().manual_seed(0))]
    elif case == "off-plane":
        pts = (torch.rand(pts.shape, generator=torch.Generator()
                          .manual_seed(1)) - 0.5) * 3.0
    pts = pts.contiguous().to(cuda)
    shape = (2, 3, *hw, 32)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, pts.shape[1], 32)).astype(np.float32)).to(cuda)
    got = triplane.sample_mean_backward(g, shape, pts, 1.0, (48, 48, 24))
    torch.cuda.synchronize()
    want = triplane.sample_mean_backward_plain(g, shape, pts, 1.0)
    _assert_grad_close(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("c", [3, 32, 35])
@pytest.mark.parametrize("n", [2, 31, 32, 33, 48, 96, 200])
def test_marcher_kernel_fast_and_general_paths_match_plain(cuda, n, c):
    """The warp-scan path (C 32) at sample counts around its chunks of 32
    and the general path (C 3, 35)."""
    colors, dens, depths = (torch.from_numpy(a).to(cuda)
                            for a in _march_inputs(16, r=21, n=n, c=c))
    got = raymarch.ray_march(colors, dens, depths)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, raymarch.ray_march_plain(colors, dens, depths)):
        torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [32, 35])
def test_marcher_kernel_on_empty_and_opaque_rays(cuda, c):
    """Rays whose density is so low that every weight is 0 (Σw = 0, the
    depth's max(·, 1e-10)), and rays so dense that the transmittance
    underflows to 0 after a few samples."""
    colors, dens, depths = (torch.from_numpy(a).to(cuda)
                            for a in _march_inputs(17, r=9, n=96, c=c))
    dens[:, :4] = -300.0
    dens[:, 4:] = 300.0
    got = raymarch.ray_march(colors, dens, depths)
    torch.cuda.synchronize()
    want = raymarch.ray_march_plain(colors, dens, depths)
    assert float(want[2][:, :4].abs().max()) == 0.0
    assert all(bool(torch.isfinite(x).all()) for x in got)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-5)


# -- the marcher's backward: routes, checks, white background -----------------


def test_marcher_white_back_as_torch_ops_matches_plain():
    """On CUDA `white_back` is `add_white_back` on the kernel's outputs:
    on the CPU, the same composition over the march without it gives the
    plain white-background march's values and, through autograd (which
    hands the term to the weights' cotangent), its gradients."""
    colors, dens, depths = (torch.from_numpy(a).requires_grad_(i < 2)
                            for i, a in enumerate(_march_inputs(18)))
    cots = [torch.from_numpy(a) for a in _march_cotangents(18, *colors.shape)]
    rgb, depth, weights = raymarch.ray_march_plain(colors, dens, depths)
    got = (raymarch.add_white_back(rgb, weights), depth, weights)
    want = raymarch.ray_march_plain(colors, dens, depths, white_back=True)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-6, atol=1e-6)
    grads = [torch.autograd.grad(out, [colors, dens], cots)
             for out in (got, want)]
    for g_, w_ in zip(*grads):
        _assert_grad_close(g_.numpy(), w_.numpy(), rel=1e-6)
    # the kernel receives the term as a weights' cotangent
    g_w = cots[2] - 2 * cots[0].sum(-1)[:, :, None, None]
    direct = raymarch.ray_march_backward_plain(
        colors, dens, depths, cots[0], cots[1], g_w)
    for g_, w_ in zip(direct, grads[1]):
        _assert_grad_close(g_.numpy(), w_.numpy(), rel=1e-5)


@pytest.mark.parametrize("rays,n,want", [
    (32768, 96, 0), (5, 1024, 0), (5, 1755, 0), (5, 1756, 8), (9, 2000, 16),
    (32768, 2000, 1024)])
def test_marcher_backward_scratch_only_past_shared_memory(rays, n, want):
    """The general path's arrays (7·N floats a warp) move to a scratch
    buffer only when they no longer fit in 48 KB; the buffer is capped at
    SCRATCH_WARPS warps, a multiple of a block's 8."""
    assert raymarch.scratch_warps_for(rays, n) == want
    assert raymarch.GENERAL_SHARED_SAMPLES * 28 <= 48 * 1024 \
        < (raymarch.GENERAL_SHARED_SAMPLES + 1) * 28


def test_marcher_backward_checks_shapes_types_and_layout():
    """The backward wrapper's checks, which run before any launch, on CPU
    tensors: cotangent shapes, fp32, contiguity, one device."""
    colors, dens, depths = (torch.from_numpy(a) for a in _march_inputs(19))
    g_rgb, g_depth, g_w = (torch.from_numpy(a)
                           for a in _march_cotangents(19, *colors.shape))
    assert raymarch._check_backward_inputs(
        colors, dens, depths, g_rgb, None, g_w) == [g_rgb, None, g_w]
    bad = [(g_rgb[..., :-1], None, None), (None, g_depth[..., 0], None),
           (None, None, g_w[:, :, 1:]), (g_rgb.double(), None, None),
           (g_rgb.transpose(0, 1).contiguous().transpose(0, 1), None, None),
           (None, g_depth.to("meta"), None)]
    for cots in bad:
        with pytest.raises(ValueError):
            raymarch._check_backward_inputs(colors, dens, depths, *cots)
    with pytest.raises(ValueError):
        raymarch._check_backward_inputs(colors, dens[:, :, 1:], depths,
                                        None, None, None)
    # a CPU call never reaches the checks' device rule: it is the plain
    # version, at any sample count
    colors, dens, depths = (torch.from_numpy(a)
                            for a in _march_inputs(19, b=1, r=2, n=1800,
                                                   c=3))
    n0 = raymarch.LAUNCHES_BWD
    got = raymarch.ray_march_backward(colors, dens, depths,
                                      torch.ones(1, 2, 3))
    assert raymarch.LAUNCHES_BWD == n0 and got[0].shape == colors.shape


@pytest.mark.gpu
@pytest.mark.parametrize("n,c", [(2, 32), (31, 32), (32, 32), (33, 32),
                                 (48, 32), (96, 32), (200, 32), (513, 32),
                                 (1024, 32), (96, 48), (40, 12), (17, 128),
                                 (1, 8), (50, 3), (33, 35), (20, 130),
                                 (1025, 32), (1, 3), (2000, 3), (2000, 32)])
@pytest.mark.parametrize("which", ["all", "rgb", "none"])
def test_marcher_backward_fast_and_general_paths_match_plain(cuda, n, c,
                                                             which):
    """The scan path (C % 4 == 0, C ≤ 128, N ≤ 1024) around its chunks of
    32 and its 8/4 warps a block, and the general path (C 3, 35, 130,
    N 1025) with its arrays in shared memory or, at N 2000, in the scratch
    buffer; under the cotangents training passes (rgb), all three, and
    none."""
    r = 21 if n < 1000 else 5
    colors, dens, depths = (torch.from_numpy(a).to(cuda)
                            for a in _march_inputs(20, r=r, n=n, c=c))
    cots = [torch.from_numpy(a).to(cuda) if which == "all" or
            (which == "rgb" and name == "rgb") else None
            for name, a in zip(("rgb", "depth", "weights"),
                               _march_cotangents(20, 2, r, n, c))]
    got = raymarch.ray_march_backward(colors, dens, depths, *cots)
    torch.cuda.synchronize()
    want = raymarch.ray_march_backward_plain(colors, dens, depths, *cots)
    for g_, w_ in zip(got, want):
        assert bool(torch.isfinite(g_).all())
        if which == "none":
            assert not g_.abs().max()
            continue
        scale = max(float(w_.abs().max()), 1e-6)
        torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [32, 35])
def test_marcher_backward_on_empty_and_opaque_rays(cuda, c):
    """Σw = 0 on the first rays, a transmittance that underflows to 0
    after a few samples on the rest: nothing is divided by it."""
    colors, dens, depths = (torch.from_numpy(a).to(cuda)
                            for a in _march_inputs(21, r=9, n=96, c=c))
    dens[:, :4] = -300.0
    dens[:, 4:] = 300.0
    cots = [torch.from_numpy(a).to(cuda)
            for a in _march_cotangents(21, 2, 9, 96, c)]
    got = raymarch.ray_march_backward(colors, dens, depths, *cots)
    torch.cuda.synchronize()
    want = raymarch.ray_march_backward_plain(colors, dens, depths, *cots)
    for g_, w_ in zip(got, want):
        assert bool(torch.isfinite(g_).all())
        scale = max(float(w_.abs().max()), 1e-6)
        torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.gpu
def test_marcher_white_back_on_the_card_matches_plain(cuda):
    """white_back=True on CUDA: the kernels plus `add_white_back`, values
    and gradients, with one backward launch."""
    colors, dens, depths = (torch.from_numpy(a).to(cuda)
                            for a in _march_inputs(22, n=48))
    colors.requires_grad_(True)
    dens.requires_grad_(True)
    cots = [torch.from_numpy(a).to(cuda)
            for a in _march_cotangents(22, 2, 37, 48, 32)]
    outs = {}
    for name, march in (("kernel", raymarch.ray_march),
                        ("plain", raymarch.ray_march_plain)):
        n0 = raymarch.LAUNCHES_BWD
        out = march(colors, dens, depths, white_back=True)
        outs[name] = (out, torch.autograd.grad(out, [colors, dens], cots),
                      raymarch.LAUNCHES_BWD - n0)
    (got, g_got, n_got), (want, g_want, n_want) = outs["kernel"], outs["plain"]
    assert (n_got, n_want) == (1, 0)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-5)
    for g_, w_ in zip(g_got, g_want):
        _assert_grad_close(g_.cpu().numpy(), w_.cpu().numpy())
