"""FIR (upfirdn2d): the kernel's wrapper, its geometry and adjoint, and
launch counts.

K9 replaces no TPU kernel: the JAX package leaves EG3D's upfirdn2d to
XLA's convolution (`hfa_gp_tpu/core/ops.py::upfirdn2d`). On the card the
port's plain version (`core/ops.upfirdn2d_plain`) copies the input twice
(zero-stuffing, padding) and runs a depthwise convolution over the
copies; the kernel, `csrc/upfirdn2d.cu`, reads the input once and writes
the output once (its header says how).

`core/ops.upfirdn2d` sends a CUDA tensor in fp32 or bf16 here and keeps
CPU and float64 tensors on the plain version. On CUDA `upfirdn2d` is a
`torch.autograd.Function` whose backward is the same function on the
adjoint geometry (`adjoint`); the adjoint's adjoint is the forward
geometry, so the kernel is differentiable to any order (R1's gradient
penalty takes the gradient of an input gradient). The taps are constants
and get no gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import build

# Launches of the CUDA kernel in this process: forward (`upfirdn2d`),
# backward (from autograd), and the backward's own backward and any order
# above it (a gradient of a gradient)
LAUNCHES = 0
LAUNCHES_BWD = 0
LAUNCHES_BWD2 = 0

FACTORS = (1, 2)             # the up and down factors the kernel takes
MAX_TAPS = 4                 # the kernel's largest kh and kw
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class Geometry(NamedTuple):
    """What the kernel computes, on each axis: y[o] = Σ_t f[t] ·
    u[o·down + t − p0] for t < k, where u is the input zero-stuffed by
    `up` (u[j] = x[j / up] where up divides j and the point lies in x, 0
    elsewhere). `taps` holds f, the flipped, gain-scaled taps, row-major
    as (kh, kw) nested tuples."""
    up: int
    down: int
    py0: int
    px0: int
    out_h: int
    out_w: int
    taps: tuple


def check(up: int, down: int, taps_shape) -> None:
    """Raise ValueError unless the kernel takes these factors and taps."""
    if up not in FACTORS or down not in FACTORS:
        raise ValueError(f"upfirdn2d: up {up} and down {down} must each be "
                         f"one of {FACTORS}")
    if len(taps_shape) != 2 or not all(1 <= k <= MAX_TAPS
                                       for k in taps_shape):
        raise ValueError(f"upfirdn2d: taps {tuple(taps_shape)}; at most "
                         f"{MAX_TAPS} x {MAX_TAPS} 2-D taps")


@functools.lru_cache(maxsize=64)
def _flipped(raw: bytes, shape: tuple, gain: float) -> tuple:
    k = np.frombuffer(raw, np.float32).reshape(shape)[::-1, ::-1] * gain
    return tuple(tuple(float(v) for v in row) for row in k)


def geometry(h: int, w: int, kernel: np.ndarray, up: int, down: int,
             pad: tuple[int, int], gain: float) -> Geometry:
    """The geometry of `ops.upfirdn2d` on an h x w input: `kernel` its 2-D
    taps (normalized, not flipped), padded by pad[0] before and pad[1]
    after on both axes."""
    kernel = np.ascontiguousarray(kernel, np.float32)
    check(up, down, kernel.shape)
    kh, kw = kernel.shape
    p0, p1 = pad
    out_h = (h * up + p0 + p1 - kh) // down + 1
    out_w = (w * up + p0 + p1 - kw) // down + 1
    if out_h < 1 or out_w < 1:
        raise ValueError(f"upfirdn2d: {h} x {w} by {kh} x {kw} taps, up "
                         f"{up}, down {down}, pad {tuple(pad)} leaves no "
                         f"output")
    return Geometry(up, down, p0, p0, out_h, out_w,
                    _flipped(kernel.tobytes(), kernel.shape, float(gain)))


def adjoint(geom: Geometry, in_h: int, in_w: int) -> Geometry:
    """The geometry of the transpose of `geom` on an in_h x in_w input, so
    that ⟨A x, y⟩ = ⟨x, Aᵀ y⟩: up and down swapped, the taps turned by
    180°, the first pads k − 1 − p0, and the input's size as the output."""
    taps = tuple(row[::-1] for row in geom.taps[::-1])
    kh, kw = len(taps), len(taps[0])
    return Geometry(geom.down, geom.up, kh - 1 - geom.py0, kw - 1 - geom.px0,
                    in_h, in_w, taps)


def _channels_last(x: torch.Tensor) -> bool:
    """Whether the kernel reads x (N, C, H, W) channels-last (C adjacent in
    memory, as a channels-last tensor or a slice of its channels) or by
    rows (W adjacent, as a contiguous tensor); raises for other strides."""
    if x.is_contiguous():
        return False
    if x.stride(1) == 1:
        return True
    if x.stride(3) == 1:
        return False
    raise ValueError("upfirdn2d: the kernel reads x with C or W adjacent in "
                     f"memory (channels-last or contiguous), not strides "
                     f"{x.stride()}")


def _launch(x: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """One launch of the kernel: x (N, C, H, W) → (N, C, out_h, out_w),
    channels-last where the kernel reads x so, else contiguous."""
    n, c, h, w = x.shape
    cl = _channels_last(x)
    # a dimension of size 1 is read at index 0 alone, whatever its stride
    strides = [st if d > 1 else 0 for st, d in zip(x.stride(), x.shape)]
    strides[1 if cl else 3] = 1
    y = torch.empty((n, c, geom.out_h, geom.out_w), dtype=x.dtype,
                    device=x.device,
                    memory_format=torch.channels_last if cl
                    else torch.contiguous_format)
    # the taps as the C function takes them: kh x kw floats on the host,
    # which the kernel receives by value
    kh, kw = len(geom.taps), len(geom.taps[0])
    taps = (ctypes.c_float * (kh * kw))(*(v for row in geom.taps for v in row))
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.hfa_upfirdn2d(
            x.data_ptr(), y.data_ptr(), taps, DTYPES[x.dtype],
            int(cl), n, c, h, w, *strides, geom.out_h, geom.out_w,
            geom.up, geom.down, kh, kw, geom.py0, geom.px0,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "hfa_upfirdn2d")
    return y


def _count(order: int) -> None:
    global LAUNCHES, LAUNCHES_BWD, LAUNCHES_BWD2
    if order == 0:
        LAUNCHES += 1
    elif order == 1:
        LAUNCHES_BWD += 1
    else:
        LAUNCHES_BWD2 += 1


class _UpFirDn2d(torch.autograd.Function):
    """The kernel on `geom`, with itself on the adjoint geometry as its
    gradient: `order` 0 is the forward, 1 its backward, 2 and above the
    backward's backward, each counted in its own counter."""

    @staticmethod
    def forward(ctx, x, geom, order):
        ctx.geom, ctx.in_hw, ctx.order = geom, tuple(x.shape[2:]), order
        y = _launch(x, geom)
        _count(order)
        return y

    @staticmethod
    def backward(ctx, g):
        if 1 not in (g.stride(1), g.stride(3)):
            g = g.contiguous()           # autograd's broadcast cotangents
        dx = _UpFirDn2d.apply(g, adjoint(ctx.geom, *ctx.in_hw),
                              ctx.order + 1)
        return dx, None, None


def upfirdn2d(x: torch.Tensor, kernel: np.ndarray, *, up: int = 1,
              down: int = 1, pad: tuple[int, int] = (0, 0),
              gain: float = 1.0) -> torch.Tensor:
    """`ops.upfirdn2d` on a CUDA tensor (N, C, H, W) in fp32 or bf16 whose
    C or W lies adjacent in memory (channels-last or contiguous, or a slice
    of either): `kernel` the 2-D taps (normalized, not flipped). The output
    is channels-last or contiguous as x is read; raises on any other
    device, dtype, strides, factor or tap size."""
    if x.device.type != "cuda":
        raise ValueError(f"upfirdn2d: the kernel runs on CUDA tensors, not "
                         f"{x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"upfirdn2d: the kernel takes fp32 or bf16, not "
                         f"{x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"upfirdn2d: x {tuple(x.shape)} is not (N, C, H, W)")
    geom = geometry(x.shape[2], x.shape[3], kernel, up, down, pad, gain)
    return _UpFirDn2d.apply(x, geom, 0)
