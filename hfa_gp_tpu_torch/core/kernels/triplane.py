"""Tri-plane sampler: dispatching wrapper, plain versions and launch counts.

Forward: replaces the TPU kernel `hfa_gp_tpu/core/pallas/triplane.py::
_sampler_kernel` (via `_sample_blocked_impl`, reached from the JAX
renderer's `eval_points`) and fuses the plane mean the JAX renderer runs
right after it; the kernel is `csrc/triplane.cu` (the template of
`csrc/triplane_sampler.cuh` with every stage on; `csrc/triplane_probe.cu`
instantiates the same template with stages removed). Backward (d planes):
replaces `_sampler_bwd_kernel_vmem` and `_sampler_bwd_kernel_hbm` (via
`_sample_blocked_bwd_vmem` / `_sample_blocked_bwd_hbm`), which compute one
function; the kernel is `csrc/triplane_bwd.cu` (its template and
launcher are `csrc/triplane_bwd.cuh`). Each source's header says what
bounds it on the H100 and how the design answers that.

The optional `layout=(h, w, n)` says that each batch element's M points
are h × w rays, row-major, of n samples each (the renderer's image of
rays): the backward kernel then sums screen tiles of rays × slabs of
samples in shared memory. It changes no result, only the order of the
backward's sums; the forward and the CPU route only check it.

On CUDA `sample_mean` is a `torch.autograd.Function` over the two kernels.
Sample coordinates get no gradient, as in the JAX package's custom VJP:
the renderer's depths are constants or detached importance samples.

The JAX chip path reads bf16 slabs and matches the exact lookup only to
about 4e-2; this port is held to the exact fp32 lookup
(`renderer.sample_from_planes`).

`sample_decode` is the lookup with the renderer's OSG decoder fused, for
inference: the kernel's decoder overload (`csrc/triplane_sampler.cuh`)
keeps the features and the hidden layer in registers and writes only rgb
and sigma. It gives no gradient. Its plain version is `sample_mean_plain`
followed by `decode_plain`, the decoder's arithmetic, which the renderer's
`decoder_apply` runs too.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import ops
from . import build

# Launches of the CUDA kernels in this process: forward (`sample_mean` and
# `sample_decode`), backward (d planes, from autograd or
# `sample_mean_backward`), and of the forward those with the decoder fused
# (`sample_decode`).
LAUNCHES = 0
LAUNCHES_BWD = 0
LAUNCHES_DECODE = 0

# The widths the fused decoder is built for: features, hidden units and
# outputs (sigma and 32 colours), as the renderer's defaults.
DECODER_WIDTHS = (32, 64, 33)

# rows: world axes spanning each plane (the corrected EG3D convention)
PLANE_AXES = np.array([
    [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
    [[1, 0, 0], [0, 0, 1], [0, 1, 0]],
    [[0, 0, 1], [1, 0, 0], [0, 1, 0]],
], dtype=np.float32)
PLANE_INV = np.linalg.inv(PLANE_AXES)  # (3, 3, 3)


def project_onto_planes(coordinates: torch.Tensor) -> torch.Tensor:
    """(B, M, 3) world coords → (B, 3, M, 2) per-plane uv."""
    inv = ops.device_constant(PLANE_INV, coordinates.dtype,
                              coordinates.device)
    return torch.einsum("bmj,pjk->bpmk", coordinates, inv)[..., :2]


def sample_from_planes(planes: torch.Tensor, coordinates: torch.Tensor,
                       box_warp: float) -> torch.Tensor:
    """planes (B, 3, H, W, C), coordinates (B, M, 3) → (B, 3, M, C):
    F.grid_sample per plane, bilinear, zeros padding, align_corners=False."""
    b, n_planes, h, w, c = planes.shape
    uv = project_onto_planes((2.0 / box_warp) * coordinates)
    grid = uv.reshape(b * n_planes, 1, -1, 2)
    img = planes.reshape(b * n_planes, h, w, c).permute(0, 3, 1, 2)
    feats = F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False)          # (B·3, C, 1, M)
    return feats[:, :, 0].permute(0, 2, 1).reshape(b, n_planes, -1, c)


def sample_mean_plain(planes: torch.Tensor, coordinates: torch.Tensor,
                      box_warp: float) -> torch.Tensor:
    """The plain PyTorch version: (B, M, C) plane-averaged features."""
    return sample_from_planes(planes, coordinates, box_warp).mean(1)


def sample_mean_backward_plain(g: torch.Tensor, planes_shape,
                               coordinates: torch.Tensor,
                               box_warp: float) -> torch.Tensor:
    """The plain PyTorch version of the backward kernel: d planes
    (B, 3, H, W, C) of `sample_mean_plain` for the cotangent g (B, M, C),
    by autograd through `F.grid_sample`."""
    with torch.enable_grad():
        planes = torch.zeros(tuple(planes_shape), dtype=g.dtype,
                             device=g.device, requires_grad=True)
        out = sample_mean_plain(planes, coordinates.detach(), box_warp)
        return torch.autograd.grad(out, planes, g)[0]


def _check_cuda_inputs(fn: str, planes_shape, dev: torch.device,
                       tensors: dict) -> None:
    """planes_shape (B, 3, H, W, C); tensors: name → tensor that must be
    fp32 and contiguous on `dev`, "coordinates" (B, M, 3) among them.
    Raises on anything else."""
    b, n_planes, _, _, _ = planes_shape
    coordinates = tensors["coordinates"]
    if n_planes != 3 or coordinates.ndim != 3 \
            or coordinates.shape[0] != b or coordinates.shape[-1] != 3:
        raise ValueError(f"{fn}: planes {tuple(planes_shape)}, "
                         f"coordinates {tuple(coordinates.shape)}")
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous fp32 "
                             f"tensor on {dev}")
    if b * coordinates.shape[1] >= 2 ** 31 \
            or int(np.prod(planes_shape[2:])) >= 2 ** 31:
        raise ValueError(f"{fn}: B·M or H·W·C exceeds the kernel's int32 "
                         f"range")


def check_layout(fn: str, layout, m: int):
    """`layout` as (h, w, n) ints with h·w·n == m (the points a batch
    element), or None; raises ValueError on anything else."""
    if layout is None:
        return None
    try:
        h, w, n = (int(x) for x in layout)
    except (TypeError, ValueError):
        raise ValueError(f"{fn}: layout must be (h, w, n), got {layout!r}") \
            from None
    if min(h, w, n) < 1 or h * w * n != m:
        raise ValueError(f"{fn}: layout {(h, w, n)} does not cover the "
                         f"{m} points of a batch element")
    return h, w, n


def sample_mean_backward(g: torch.Tensor, planes_shape,
                         coordinates: torch.Tensor, box_warp: float,
                         layout=None) -> torch.Tensor:
    """d planes (B, 3, H, W, C) for the cotangent g (B, M, C) of
    `sample_mean`, with the points' optional `layout` (h, w, n). A CPU
    tensor goes to `sample_mean_backward_plain`; a CUDA tensor launches
    the backward kernel (fp32, contiguous) or raises. The kernel sums with
    atomics, so its last bits change from run to run."""
    layout = check_layout("sample_mean_backward", layout,
                          coordinates.shape[1])
    if g.device.type == "cpu":
        return sample_mean_backward_plain(g, planes_shape, coordinates,
                                          box_warp)
    if g.device.type != "cuda":
        raise ValueError(f"sample_mean_backward: unsupported device "
                         f"{g.device}")
    b, _, h, w, c = planes_shape
    _check_cuda_inputs("sample_mean_backward", planes_shape, g.device,
                       {"coordinates": coordinates, "g": g})
    m = coordinates.shape[1]
    if g.shape != (b, m, c):
        raise ValueError(f"sample_mean_backward: g {tuple(g.shape)}, "
                         f"expected {(b, m, c)}")
    grad = torch.zeros(tuple(planes_shape), dtype=torch.float32,
                       device=g.device)
    lh, lw, ln = layout or (1, 1, m)
    lib = build.library()
    global LAUNCHES_BWD
    with torch.cuda.device(g.device):
        err = lib.hfa_triplane_mean_bwd(
            g.data_ptr(), coordinates.data_ptr(), grad.data_ptr(),
            b, m, h, w, c, 2.0 / box_warp, lh, lw, ln,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "hfa_triplane_mean_bwd")
    LAUNCHES_BWD += 1
    return grad


def _launch_forward(planes: torch.Tensor, coordinates: torch.Tensor,
                    box_warp: float) -> torch.Tensor:
    b, _, h, w, c = planes.shape
    _check_cuda_inputs("sample_mean", planes.shape, planes.device,
                       {"coordinates": coordinates, "planes": planes})
    m = coordinates.shape[1]
    out = torch.empty((b, m, c), dtype=torch.float32, device=planes.device)
    lib = build.library()
    global LAUNCHES
    with torch.cuda.device(planes.device):
        err = lib.hfa_triplane_mean(
            planes.data_ptr(), coordinates.data_ptr(), out.data_ptr(),
            b, m, h, w, c, 2.0 / box_warp,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "hfa_triplane_mean")
    LAUNCHES += 1
    return out


class _SampleMean(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient
    (planes only)."""

    @staticmethod
    def forward(ctx, planes, coordinates, box_warp, layout):
        ctx.save_for_backward(coordinates)
        ctx.planes_shape = tuple(planes.shape)
        ctx.box_warp = box_warp
        ctx.layout = layout
        return _launch_forward(planes, coordinates, box_warp)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (coordinates,) = ctx.saved_tensors
        return sample_mean_backward(g.contiguous(), ctx.planes_shape,
                                    coordinates, ctx.box_warp,
                                    ctx.layout), None, None, None


def sample_mean(planes: torch.Tensor, coordinates: torch.Tensor,
                box_warp: float, layout=None) -> torch.Tensor:
    """Plane-averaged tri-plane features (B, M, C), differentiable in
    `planes`; `layout` (h, w, n), optional, is how the points lie (see the
    module's docstring).

    A CPU tensor goes to `sample_mean_plain`; a CUDA tensor launches the
    kernels (fp32, contiguous) or raises. On CUDA `coordinates` must not
    require a gradient: the kernels give none, and a silent zero would
    train differently from the CPU."""
    layout = check_layout("sample_mean", layout, coordinates.shape[1])
    if planes.device.type == "cpu":
        return sample_mean_plain(planes, coordinates, box_warp)
    if planes.device.type != "cuda":
        raise ValueError(f"sample_mean: unsupported device {planes.device}")
    if coordinates.requires_grad:
        raise ValueError("sample_mean: the CUDA kernels give no gradient to "
                         "coordinates; detach them")
    return _SampleMean.apply(planes, coordinates, box_warp, layout)


# -- the decoder fused ------------------------------------------------------


def decode_plain(decoder, lr_multiplier: float, x: torch.Tensor,
                 out_dtype: torch.dtype | None = None):
    """The OSG decoder on features x (..., C) in x's dtype: fc0, softplus,
    fc1, cast to `out_dtype` (default x's), then (rgb (..., 32) =
    sigmoid(out[1:]) · 1.002 − 0.001, sigma (..., 1) = out[0]). `decoder`
    is {"fc0": {"weight", "bias"}, "fc1": {...}}, weights (out, in)."""
    x = ops.fully_connected(x, decoder["fc0"]["weight"],
                            decoder["fc0"]["bias"],
                            lr_multiplier=lr_multiplier)
    x = F.softplus(x)
    x = ops.fully_connected(x, decoder["fc1"]["weight"],
                            decoder["fc1"]["bias"],
                            lr_multiplier=lr_multiplier)
    if out_dtype is not None:
        x = x.to(out_dtype)
    sigma = x[..., 0:1]
    rgb = torch.sigmoid(x[..., 1:]) * (1 + 2 * 0.001) - 0.001
    return rgb, sigma


def sample_decode_plain(planes: torch.Tensor, coordinates: torch.Tensor,
                        box_warp: float, decoder, lr_multiplier: float):
    """The plain PyTorch version of `sample_decode`: `sample_mean_plain`,
    then `decode_plain`."""
    return decode_plain(decoder, lr_multiplier,
                        sample_mean_plain(planes, coordinates, box_warp))


def decoder_leaves(decoder) -> list[torch.Tensor]:
    """fc0's weight and bias, then fc1's."""
    return [decoder[k][n] for k in ("fc0", "fc1") for n in ("weight", "bias")]


def decodes(planes: torch.Tensor, decoder) -> bool:
    """Whether the fused kernel is built for these widths: planes of
    DECODER_WIDTHS[0] channels and a decoder of DECODER_WIDTHS."""
    c, hidden, out = DECODER_WIDTHS
    w0, b0, w1, b1 = decoder_leaves(decoder)
    return (planes.shape[-1] == c and tuple(w0.shape) == (hidden, c)
            and tuple(b0.shape) == (hidden,)
            and tuple(w1.shape) == (out, hidden)
            and tuple(b1.shape) == (out,))


def sample_decode(planes: torch.Tensor, coordinates: torch.Tensor,
                  box_warp: float, decoder, lr_multiplier: float,
                  layout=None):
    """The plane-averaged features of `sample_mean` through the OSG
    decoder of `decode_plain`: (rgb (B, M, 32), sigma (B, M, 1)), with no
    gradient. `layout` is checked as `sample_mean` checks it.

    A CPU tensor goes to `sample_decode_plain`; a CUDA tensor launches the
    fused kernel (fp32, contiguous, the widths of `decodes`) or raises,
    also where autograd would want a gradient of an input."""
    check_layout("sample_decode", layout, coordinates.shape[1])
    if planes.device.type == "cpu":
        return sample_decode_plain(planes, coordinates, box_warp, decoder,
                                   lr_multiplier)
    if planes.device.type != "cuda":
        raise ValueError(f"sample_decode: unsupported device {planes.device}")
    leaves = decoder_leaves(decoder)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (planes, coordinates, *leaves)):
        raise ValueError("sample_decode: the fused kernel gives no gradient; "
                         "call it with autograd off or on inputs that need "
                         "none")
    if not decodes(planes, decoder):
        raise ValueError(f"sample_decode: the fused kernel takes planes of "
                         f"{DECODER_WIDTHS[0]} channels and a decoder "
                         f"{DECODER_WIDTHS}, got planes "
                         f"{tuple(planes.shape)}, fc0 "
                         f"{tuple(leaves[0].shape)}, fc1 "
                         f"{tuple(leaves[2].shape)}")
    b, _, h, w, c = planes.shape
    w0, b0, w1, b1 = leaves
    _check_cuda_inputs("sample_decode", planes.shape, planes.device,
                       {"coordinates": coordinates, "planes": planes,
                        "fc0.weight": w0, "fc0.bias": b0, "fc1.weight": w1,
                        "fc1.bias": b1})
    m = coordinates.shape[1]
    rgb = torch.empty((b, m, DECODER_WIDTHS[2] - 1), dtype=torch.float32,
                      device=planes.device)
    sigma = torch.empty((b, m, 1), dtype=torch.float32, device=planes.device)
    lib = build.library()
    global LAUNCHES, LAUNCHES_DECODE
    with torch.cuda.device(planes.device):
        err = lib.hfa_triplane_mean_decode(
            planes.data_ptr(), coordinates.data_ptr(), w0.data_ptr(),
            b0.data_ptr(), w1.data_ptr(), b1.data_ptr(), rgb.data_ptr(),
            sigma.data_ptr(), b, m, h, w, c, 2.0 / box_warp,
            lr_multiplier / math.sqrt(w0.shape[1]),
            lr_multiplier / math.sqrt(w1.shape[1]), lr_multiplier,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "hfa_triplane_mean_decode")
    LAUNCHES += 1
    LAUNCHES_DECODE += 1
    return rgb, sigma
