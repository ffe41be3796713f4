"""Tri-plane sampler: dispatching wrapper, plain versions and launch counts.

Forward: replaces the TPU kernel `hfa_gp_tpu/core/pallas/triplane.py::
_sampler_kernel` (via `_sample_blocked_impl`, reached from the JAX
renderer's `eval_points`) and fuses the plane mean the JAX renderer runs
right after it; the kernel is `csrc/triplane.cu` (the template of
`csrc/triplane_sampler.cuh` with every stage on; `csrc/triplane_probe.cu`
instantiates the same template with stages removed). Backward (d planes):
replaces `_sampler_bwd_kernel_vmem` and `_sampler_bwd_kernel_hbm` (via
`_sample_blocked_bwd_vmem` / `_sample_blocked_bwd_hbm`), which compute one
function; the kernel is `csrc/triplane_bwd.cu` (the template of
`csrc/triplane_bwd.cuh` with every stage on; `csrc/triplane_bwd_probe.cu`
instantiates it with stages removed). Each source's header says what
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
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import ops
from . import build

# Launches of the CUDA kernels in this process: forward (`sample_mean`) and
# backward (d planes, from autograd or `sample_mean_backward`).
LAUNCHES = 0
LAUNCHES_BWD = 0

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
