"""The port's two kernel modules (core/kernels/{triplane,raymarch}.py):
their plain versions against the JAX package, the dispatch of the
wrappers, and (marked `gpu`, card only) each CUDA kernel against its
plain version.

Tolerances: the sampler is an fp32 bilinear lookup whose texel coordinate
is computed in another rounding order than JAX's ((u+1)·W−1)/2 vs
(u+1)·(W/2)−0.5), 1e-5 on unit-normal planes. The marcher uses the JAX
package's own kernel test bound, rtol 1e-4 / atol 1e-5.
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
    with pytest.raises(NotImplementedError):
        raymarch.ray_march(colors, dens, depths, white_back=True)
    with pytest.raises(ValueError):
        raymarch.ray_march(colors, dens[..., :-1, :], depths)
