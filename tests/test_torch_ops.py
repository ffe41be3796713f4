"""The port's core/ops.py against the JAX package's, on the same seeded
numpy inputs.

Tolerances: elementwise ops agree to fp32 rounding (1e-6). Convolutions
sum up to a few hundred products in another order (XLA vs oneDNN), so
they are held to rtol = atol = 1e-5 on unit-scale outputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfa_gp_tpu.core import ops as jops
from hfa_gp_tpu_torch.core import ops as tops


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("act", ["linear", "lrelu", "relu", "sigmoid",
                                 "tanh", "softplus"])
@pytest.mark.parametrize("clamp", [None, 0.7])
def test_bias_act(act, clamp):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 6, 7)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    want = jops.bias_act(jnp.asarray(x), jnp.asarray(b), act=act,
                         clamp=clamp)
    got = tops.bias_act(nchw(x), torch.from_numpy(b), act=act, clamp=clamp)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_fused_leaky_relu_and_normalize_2nd_moment():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4, 5, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    want = jops.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b))
    got = tops.fused_leaky_relu(nchw(x), torch.from_numpy(b))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    z = rng.standard_normal((4, 9)).astype(np.float32)
    np.testing.assert_allclose(
        tops.normalize_2nd_moment(torch.from_numpy(z)).numpy(),
        np.asarray(jops.normalize_2nd_moment(jnp.asarray(z))), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("up,down,pad", [(1, 1, (1, 2)), (2, 1, (2, 1)),
                                         (1, 2, (1, 1)), (2, 2, (0, 3))])
def test_upfirdn2d_asymmetric_kernel(up, down, pad):
    """An asymmetric 2-D kernel catches a missing or doubled flip."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 11, 3)).astype(np.float32)
    k = rng.uniform(0.1, 1.0, (4, 3)).astype(np.float32)
    want = jops.upfirdn2d(jnp.asarray(x), k, up=up, down=down, pad=pad,
                          gain=1.5)
    got = tops.upfirdn2d(nchw(x), k, up=up, down=down, pad=pad, gain=1.5)
    assert nhwc(got).shape == want.shape
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_blur_upsample_downsample():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    fir = jops.make_fir_kernel([1, 3, 3, 1])
    np.testing.assert_array_equal(tops.make_fir_kernel([1, 3, 3, 1]), fir)
    for jf, tf, kw in ((jops.upsample2d, tops.upsample2d, {}),
                       (jops.downsample2d, tops.downsample2d, {}),
                       (jops.blur, tops.blur, {"pad": (2, 1)})):
        want = jf(jnp.asarray(x), fir, **kw)
        got = tf(nchw(x), fir, **kw)
        np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("up,demodulate,k", [
    (1, True, 3), (1, False, 3), (2, True, 3), (2, False, 3),
    (1, False, 1)])                      # 1x1 without demod: torgb
def test_modulated_conv2d(up, demodulate, k):
    """Asymmetric random weights: the up=2 branch needs the spatial flip
    and the in/out transpose of conv_transpose2d to match the JAX
    lhs_dilation correlation."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 7, 6, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 4)).astype(np.float32)
    s = rng.uniform(0.5, 1.5, (3, 5)).astype(np.float32)
    want = jops.modulated_conv2d(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(s), demodulate=demodulate,
                                 up=up, padding=k // 2)
    got = tops.modulated_conv2d(nchw(x), oihw(w), torch.from_numpy(s),
                                demodulate=demodulate, up=up, padding=k // 2)
    assert nhwc(got).shape == want.shape
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("stride,padding,bias", [(1, 1, True), (2, 0, False),
                                                 (1, 0, True)])
def test_equal_conv2d(stride, padding, bias):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 9, 6)).astype(np.float32)
    w = rng.standard_normal((3, 3, 6, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32) if bias else None
    want = jops.equal_conv2d(jnp.asarray(x), jnp.asarray(w),
                             None if b is None else jnp.asarray(b),
                             stride=stride, padding=padding)
    got = tops.equal_conv2d(nchw(x), oihw(w),
                            None if b is None else torch.from_numpy(b),
                            stride=stride, padding=padding)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("activation,lr", [("linear", 1.0), ("lrelu", 0.01),
                                           ("softplus", 0.5)])
def test_fully_connected(activation, lr):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 3, 12)).astype(np.float32)
    w = rng.standard_normal((7, 12)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    want = jops.fully_connected(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), activation=activation,
                                lr_multiplier=lr)
    got = tops.fully_connected(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b), activation=activation,
                               lr_multiplier=lr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("activation", [None, "fused_lrelu"])
def test_equal_linear(activation):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 12)).astype(np.float32)
    w = rng.standard_normal((7, 12)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    want = jops.equal_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             lr_mul=0.5, activation=activation)
    got = tops.equal_linear(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), lr_mul=0.5,
                            activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
