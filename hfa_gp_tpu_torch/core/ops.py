"""StyleGAN2 / EG3D primitives in PyTorch (port of hfa_gp_tpu/core/ops.py).

Layouts: image tensors are NCHW and conv weights OIHW (the JAX package is
NHWC / HWIO; utils/convert.py transposes its weights). FC weights are
(out, in) in both packages. Plain PyTorch throughout: convolutions go to
cuDNN, matrix products to cuBLAS.

Dtypes, as in the JAX package: each op runs in the dtype of its input `x`
(fp32, or bf16 under `--bf16`), and casts the fp32 master weights, biases
and styles to it; no `torch.autocast`.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def _channel_view(v: torch.Tensor, ndim: int, dim: int) -> torch.Tensor:
    """Reshape a (C,) vector to broadcast along axis `dim` of an ndim tensor."""
    shape = [1] * ndim
    shape[dim] = -1
    return v.reshape(shape)


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor | None = None,
                     negative_slope: float = 0.2,
                     scale: float = math.sqrt(2.0)) -> torch.Tensor:
    """leaky_relu(x + b) * scale, bias on the channel axis (dim 1)."""
    if bias is not None:
        x = x + _channel_view(bias.to(x.dtype), x.ndim, 1)
    return F.leaky_relu(x, negative_slope) * scale


def bias_act(x: torch.Tensor, bias: torch.Tensor | None = None, *,
             act: str = "linear", gain: float | None = None,
             clamp: float | None = None, dim: int = 1) -> torch.Tensor:
    """EG3D bias_act: bias on axis `dim`, activation, gain, clamp.

    act ∈ {linear, relu, lrelu, sigmoid, tanh, softplus}; lrelu's default
    gain is sqrt(2), every other activation's is 1."""
    if bias is not None:
        x = x + _channel_view(bias.to(x.dtype), x.ndim, dim)
    if act == "linear":
        pass
    elif act == "relu":
        x = F.relu(x)
    elif act == "lrelu":
        x = F.leaky_relu(x, 0.2)
        if gain is None:
            gain = math.sqrt(2.0)
    elif act == "sigmoid":
        x = torch.sigmoid(x)
    elif act == "tanh":
        x = torch.tanh(x)
    elif act == "softplus":
        x = F.softplus(x)
    else:
        raise ValueError(f"unknown act {act!r}")
    if gain is not None and gain != 1.0:
        x = x * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return x


def make_fir_kernel(k: Sequence[float] | np.ndarray) -> np.ndarray:
    """Normalized separable 2-D FIR kernel from 1-D taps."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return k / k.sum()


# Host constants kept on the card: a per-call copy from pageable memory
# would synchronise the host with the card and break a CUDA graph's
# capture
_ON_DEVICE: dict = {}


def _kept(key, make) -> torch.Tensor:
    """The tensor `make()` built under `key`, built once: outside inference
    mode, so that autograd may save it later, and never written to."""
    t = _ON_DEVICE.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _ON_DEVICE[key] = make()
    return t


def device_constant(array: np.ndarray, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """A NumPy constant as a tensor in `dtype` on `device`, copied from the
    host once per (values, dtype, device). Callers must not write to it."""
    return _kept((array.tobytes(), array.shape, array.dtype.str, dtype,
                  torch.device(device)),
                 lambda: torch.as_tensor(array, dtype=dtype, device=device))


def fir_taps(kernel, gain: float, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """The flipped, gain-scaled 2-D FIR taps (kh, kw) of `kernel` (1-D
    taps, normalized by `make_fir_kernel`, or a 2-D kernel) in `dtype` on
    `device`: built in NumPy and copied from the host once per (taps,
    gain, dtype, device)."""
    kernel = np.asarray(kernel, np.float32)

    def make():
        k = make_fir_kernel(kernel) if kernel.ndim == 1 else kernel
        return torch.as_tensor(np.ascontiguousarray(k[::-1, ::-1]) * gain,
                               dtype=dtype, device=device)

    return _kept(("fir", kernel.tobytes(), kernel.shape, float(gain), dtype,
                  torch.device(device)), make)


def upfirdn2d(x: torch.Tensor, kernel, *, up: int = 1, down: int = 1,
              pad: tuple[int, int] = (0, 0),
              gain: float = 1.0) -> torch.Tensor:
    """Zero-stuff upsample → pad → FIR → downsample on NCHW `x`.

    Output length per axis: (H·up + pad0 + pad1 − kh) // down + 1. The
    zero-stuffing leaves (up − 1) trailing zeros, as the reference does.
    The FIR is a true convolution: correlate with the flipped kernel
    (`fir_taps`)."""
    k = fir_taps(kernel, gain, x.dtype, x.device)
    kh, kw = k.shape
    b, c, h, w = x.shape
    if up > 1:
        x = x.reshape(b, c, h, 1, w, 1)
        x = F.pad(x, (0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(b, c, h * up, w * up)
    pad0, pad1 = pad
    x = F.pad(x, (pad0, pad1, pad0, pad1))
    k = k[None, None].expand(c, 1, kh, kw)
    return F.conv2d(x, k, stride=down, groups=c)


def blur(x: torch.Tensor, kernel, pad: tuple[int, int],
         upsample_factor: int = 1) -> torch.Tensor:
    """FIR blur (reference Blur module)."""
    return upfirdn2d(x, kernel, pad=pad, gain=float(upsample_factor) ** 2)


def upsample2d(x: torch.Tensor, kernel, factor: int = 2) -> torch.Tensor:
    """2x FIR upsample (EG3D upfirdn2d.upsample2d)."""
    kh = np.asarray(kernel).shape[0]
    p0 = (kh + factor - 1) // 2
    p1 = (kh - factor) // 2
    return upfirdn2d(x, kernel, up=factor, pad=(p0, p1),
                     gain=float(factor) ** 2)


def downsample2d(x: torch.Tensor, kernel, factor: int = 2) -> torch.Tensor:
    kh = np.asarray(kernel).shape[0]
    p0 = (kh - factor + 1) // 2
    p1 = (kh - factor) // 2
    return upfirdn2d(x, kernel, down=factor, pad=(p0, p1))


def equal_linear(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None = None, *, lr_mul: float = 1.0,
                 activation: str | None = None) -> torch.Tensor:
    """y = x @ (w · lr_mul/sqrt(in)).T (+ b·lr_mul); weight (out, in)."""
    scale = (1.0 / math.sqrt(weight.shape[1])) * lr_mul
    y = x @ (weight * scale).T
    b = None if bias is None else bias * lr_mul
    if activation:  # 'fused_lrelu'
        return fused_leaky_relu(y, b)
    if b is not None:
        y = y + b
    return y


def equal_conv2d(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None = None, *, stride: int = 1,
                 padding: int = 0) -> torch.Tensor:
    """Equal-lr conv2d, NCHW x, OIHW weight, scale 1/sqrt(cin·kh·kw)."""
    _, cin, kh, kw = weight.shape
    scale = 1.0 / math.sqrt(cin * kh * kw)
    return F.conv2d(x, weight * scale, bias, stride=stride, padding=padding)


def fully_connected(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor | None = None, *,
                    activation: str = "linear",
                    lr_multiplier: float = 1.0) -> torch.Tensor:
    """EG3D FullyConnectedLayer on the last axis; weight (out, in), cast to
    the dtype of x."""
    gain = lr_multiplier / math.sqrt(weight.shape[1])
    y = x @ (weight.to(x.dtype) * gain).T
    b = None if bias is None else bias * lr_multiplier
    return bias_act(y, b, act=activation, dim=-1)


def normalize_2nd_moment(x: torch.Tensor, dim: int = -1,
                         eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor,
                     styles: torch.Tensor, *, demodulate: bool = True,
                     up: int = 1, padding: int = 0, resample_filter=None,
                     eps: float = 1e-8) -> torch.Tensor:
    """StyleGAN2 modulated conv in the grouped-conv form.

    x (B, Cin, H, W); weight (Cout, Cin, kh, kw); styles (B, Cin). Each
    sample gets its own weight w·s (·d when demodulating), and one grouped
    conv (groups = B) runs the batch in the dtype of x.

    The per-sample weight is folded in fp32 (d summed in fp32, as the JAX
    package's comment asks; in float64 for a float64 x) and cast to x's
    dtype once. In bf16 that rounds in other places than the JAX
    package's order, which scales x by s, runs one conv with the shared
    weight and scales y by d, each in bf16: the weight is rounded once
    here, where JAX rounds x·s and y·d.

    up=2 is the JAX package's `lhs_dilation` correlation with padding
    kh−1, which equals `conv_transpose2d(stride=2)` with the kernel
    spatially FLIPPED and in/out swapped; the FIR then smooths the
    (2H + kh − 2) result down to exactly 2H."""
    b, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    acc = torch.promote_types(x.dtype, torch.float32)   # fp32 at least
    wb = weight.to(acc)[None] \
        * styles.to(acc)[:, None, :, None, None]        # (B, O, I, kh, kw)
    if demodulate:
        wb = wb * torch.rsqrt(wb.square().sum(dim=(2, 3, 4), keepdim=True)
                              + eps)
    wb = wb.to(x.dtype)
    xg = x.reshape(1, b * cin, h, w)
    if up == 1:
        y = F.conv2d(xg, wb.reshape(b * cout, cin, kh, kw), padding=padding,
                     groups=b)
    elif up == 2:
        if resample_filter is None:
            resample_filter = make_fir_kernel([1, 3, 3, 1])
        resample_filter = np.asarray(resample_filter, np.float32)
        if resample_filter.ndim == 1:
            resample_filter = make_fir_kernel(resample_filter)
        fh = resample_filter.shape[0]
        wt = wb.flip(3, 4).transpose(1, 2).reshape(b * cin, cout, kh, kw)
        y = F.conv_transpose2d(xg, wt, stride=2, groups=b)
        ptot = fh + 1 - kh
        y = upfirdn2d(y, resample_filter, pad=((ptot + 1) // 2, ptot // 2),
                      gain=4.0)
    else:
        raise NotImplementedError(f"up={up}")
    return y.reshape(b, cout, y.shape[2], y.shape[3])


def avg_pool_to(x: torch.Tensor, size: int) -> torch.Tensor:
    """AdaptiveAvgPool2d((size, size)) for channel-last images (B, H, W, C)
    whose H and W are integer multiples of `size` (512 → 256 for the
    training loss)."""
    b, h, w, c = x.shape
    if h == size and w == size:
        return x
    if h % size or w % size:
        raise ValueError(f"avg_pool_to: {h}x{w} is no multiple of {size}")
    return x.reshape(b, size, h // size, size, w // size, c).mean(dim=(2, 4))
