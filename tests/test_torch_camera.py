"""The port's core/camera.py against the JAX package's.

Deterministic functions are compared on the same seeded numpy inputs at
fp32 rounding (1e-6 abs on unit-scale values, 1e-5 for rays, whose
normalization divides by a norm computed in another order). The random
camera modes cannot share JAX's random bits; they are checked for the
sphere they sample.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfa_gp_tpu.core import camera as jcam
from hfa_gp_tpu_torch.core import camera as tcam

# One intra-op thread: the suite runs several worker processes side by
# side, and a thread pool per worker as wide as the machine makes them wait
# on each other (the port's CPU tests: 468 s with the default, 216 s so).
torch.set_num_threads(1)


def _labels(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 25)).astype(np.float32)


def test_flip_pack_unpack_label():
    lab = _labels()
    np.testing.assert_array_equal(
        tcam.flip_yz_label(torch.from_numpy(lab)).numpy(),
        np.asarray(jcam.flip_yz_label(jnp.asarray(lab))))
    c2w, intr = tcam.unpack_label(torch.from_numpy(lab))
    jc2w, jintr = jcam.unpack_label(jnp.asarray(lab))
    np.testing.assert_array_equal(c2w.numpy(), np.asarray(jc2w))
    np.testing.assert_array_equal(intr.numpy(), np.asarray(jintr))
    np.testing.assert_array_equal(
        tcam.pack_label(c2w).numpy(), np.asarray(jcam.pack_label(jc2w)))


@pytest.mark.parametrize("h,v", [(0.5 * math.pi, 0.5 * math.pi),
                                 (1.9, 1.3), (1.2, 2.0)])
def test_sample_camera_label_deterministic(h, v):
    want = jcam.sample_camera_label(None, n=2, horizontal_mean=h,
                                    vertical_mean=v, mode=None)
    got = tcam.sample_camera_label(None, n=2, horizontal_mean=h,
                                   vertical_mean=v, mode=None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_create_cam2world_matrix_and_normalize():
    rng = np.random.default_rng(1)
    origin = rng.standard_normal((4, 3)).astype(np.float32) * 2.7
    fwd = -origin + 0.1 * rng.standard_normal((4, 3)).astype(np.float32)
    want = jcam.create_cam2world_matrix(jnp.asarray(fwd), jnp.asarray(origin))
    got = tcam.create_cam2world_matrix(torch.from_numpy(fwd),
                                       torch.from_numpy(origin))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        tcam.normalize_vecs(torch.from_numpy(fwd)).numpy(),
        np.asarray(jcam.normalize_vecs(jnp.asarray(fwd))), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("skew", [0.0, 0.03])
def test_generate_rays(skew):
    lab = np.asarray(jcam.flip_yz_label(jcam.sample_camera_label(
        None, n=2, horizontal_mean=1.8, mode=None)))
    lab = lab.copy()
    lab[:, 17] = skew                          # intrinsics (0, 1)
    lab[1, 18] = 0.47                          # principal point cx
    c2w, intr = jcam.unpack_label(jnp.asarray(lab))
    jo, jd = jcam.generate_rays(c2w, intr, 12)
    tc2w, tintr = tcam.unpack_label(torch.from_numpy(lab))
    to, td = tcam.generate_rays(tc2w, tintr, 12)
    assert to.shape == jo.shape and td.shape == jd.shape == (2, 144, 3)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["uniform", "normal", "gaussian",
                                  "spherical_uniform", "truncated_gaussian",
                                  "hybrid"])
def test_sample_camera_positions_random_modes(mode):
    g = torch.Generator().manual_seed(0)
    pts, phi, theta = tcam.sample_camera_positions(
        g, n=64, r=2.7, horizontal_stddev=0.3, vertical_stddev=0.155,
        mode=mode)
    assert pts.shape == (64, 3)
    np.testing.assert_allclose(torch.linalg.vector_norm(pts, dim=-1).numpy(),
                               2.7, rtol=1e-5)
    assert bool(((phi > 0) & (phi < math.pi)).all())
    assert float(theta.std()) > 0.0
    # same seed → same cameras
    again = tcam.sample_camera_positions(
        torch.Generator().manual_seed(0), n=64, r=2.7,
        horizontal_stddev=0.3, vertical_stddev=0.155, mode=mode)[0]
    np.testing.assert_array_equal(pts.numpy(), again.numpy())


def test_random_mode_needs_generator():
    with pytest.raises(ValueError):
        tcam.sample_camera_positions(None, mode="gaussian")
