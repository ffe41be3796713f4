"""The port's LPIPS (models/lpips.py) and `ops.avg_pool_to` against the JAX
package: the same numpy-seeded images through both, params made by the JAX
init and carried across by `convert.from_jax`.

Tolerance: 1e-5 on the distance (five fp32 conv layers, sums in another
order), 1e-4 × the gradient's scale on the image gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfa_gp_tpu.core import ops as jops
from hfa_gp_tpu.models import lpips as jlpips
from hfa_gp_tpu_torch.core import ops as tops
from hfa_gp_tpu_torch.models import lpips as tlpips
from hfa_gp_tpu_torch.utils import convert

# One intra-op thread: the suite runs several worker processes side by
# side, and a thread pool per worker as wide as the machine makes them wait
# on each other (the port's CPU tests: 468 s with the default, 216 s so).
torch.set_num_threads(1)


def _images(seed, b=2, size=64):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
    return a, (a + 0.3 * rng.standard_normal(a.shape)).clip(-1, 1) \
        .astype(np.float32)


@pytest.fixture(scope="module")
def lpips_params():
    jp = jax.tree.map(np.array, jlpips.init_lpips(jax.random.PRNGKey(1)))
    jp["lin2"]["weight"][::3] *= -1.0        # the relu on the heads matters
    return jp, convert.from_jax(jp)


@pytest.mark.parametrize("size", [64, 96])
def test_lpips_distance_matches_jax(lpips_params, size):
    jp, tp = lpips_params
    a, b = _images(0, size=size)
    want = np.asarray(jlpips.lpips_distance(jp, jnp.asarray(a),
                                            jnp.asarray(b)))
    with torch.inference_mode():
        got = tlpips.lpips_distance(tp, torch.from_numpy(a),
                                    torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert float(want.min()) > 1e-3


def test_lpips_image_gradient_matches_jax(lpips_params):
    jp, tp = lpips_params
    a, b = _images(1)
    want = np.asarray(jax.grad(lambda x: jnp.mean(jlpips.lpips_distance(
        jp, jnp.asarray(a), x)))(jnp.asarray(b)))
    x = torch.from_numpy(b).requires_grad_(True)
    (got,) = torch.autograd.grad(
        tlpips.lpips_distance(tp, torch.from_numpy(a), x).mean(), x)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * scale)


def test_lpips_of_equal_images_is_zero(lpips_params):
    _, tp = lpips_params
    a, _ = _images(2)
    with torch.inference_mode():
        d = tlpips.lpips_distance(tp, torch.from_numpy(a),
                                  torch.from_numpy(a))
    assert float(d.abs().max()) == 0.0


def test_init_lpips_has_the_jax_tree(lpips_params):
    """The port's own random init: the converted JAX tree's keys and
    shapes, non-negative heads, zero biases."""
    _, tp = lpips_params
    mine = convert.ParamTree(tlpips.init_lpips(
        torch.Generator().manual_seed(0)))
    want = {k: tuple(v.shape) for k, v in tp.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in mine.state_dict().items()} == want
    for i in range(5):
        assert float(mine[f"lin{i}"]["weight"].min()) >= 0.0
        assert float(mine[f"conv{i}"]["bias"].abs().max()) == 0.0


@pytest.mark.parametrize("h,size", [(64, 64), (64, 32), (96, 32), (64, 16)])
def test_avg_pool_to_matches_jax(h, size):
    x = np.random.default_rng(3).standard_normal((2, h, h, 3)) \
        .astype(np.float32)
    want = np.asarray(jops.avg_pool_to(jnp.asarray(x), size))
    got = tops.avg_pool_to(torch.from_numpy(x), size)
    assert got.shape == want.shape == (2, size, size, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_avg_pool_to_raises_on_a_size_that_does_not_divide():
    with pytest.raises(ValueError):
        tops.avg_pool_to(torch.zeros(1, 64, 64, 3), 48)
