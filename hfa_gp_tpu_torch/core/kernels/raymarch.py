"""Ray marcher: dispatching wrapper, plain versions and launch counts.

Forward: replaces the TPU kernel `hfa_gp_tpu/core/pallas/raymarch.py::
_march_kernel` (via `pallas_ray_march`); the kernel is `csrc/raymarch.cu`.
The JAX package leaves its kernel off by default and has no backward for
it (it trains through the automatic differentiation of
`renderer.ray_march`); the port runs its kernel on both passes and gives
it a backward kernel, `csrc/raymarch_bwd.cu`. Each source's header says
what bounds it on the H100 (memory) and how the design answers that.

On CUDA `ray_march` is a `torch.autograd.Function` over the two kernels,
with the batch-global depth clip as torch ops around it. Depths get no
gradient: in the renderer they are constants or detached importance
samples.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

# Launches of the CUDA kernels in this process: forward (`ray_march`) and
# backward (from autograd or `ray_march_backward`).
LAUNCHES = 0
LAUNCHES_BWD = 0

# The backward kernel's general path keeps 7·N floats a warp in shared
# memory while they fit in 48 KB; beyond, in a scratch buffer of that many
# floats for each of up to SCRATCH_WARPS warps, which stride over the rays.
GENERAL_SHARED_SAMPLES = 48 * 1024 // (7 * 4)
SCRATCH_WARPS = 1024


def _march_unclipped(colors: torch.Tensor, densities: torch.Tensor,
                     depths: torch.Tensor, white_back: bool):
    """`ray_march_plain` before its depth clip (what the kernels compute)."""
    deltas = depths[:, :, 1:] - depths[:, :, :-1]
    colors_mid = (colors[:, :, :-1] + colors[:, :, 1:]) / 2
    densities_mid = (densities[:, :, :-1] + densities[:, :, 1:]) / 2
    depths_mid = (depths[:, :, :-1] + depths[:, :, 1:]) / 2
    densities_mid = F.softplus(densities_mid - 1.0)
    alpha = 1.0 - torch.exp(-(densities_mid * deltas))
    trans = torch.cumprod(torch.cat(
        [torch.ones_like(alpha[:, :, :1]), 1.0 - alpha + 1e-10], dim=2),
        dim=2)
    weights = alpha * trans[:, :, :-1]
    rgb = torch.sum(weights * colors_mid, dim=2)
    weight_total = torch.sum(weights, dim=2)
    depth = torch.sum(weights * depths_mid, dim=2) \
        / weight_total.clamp_min(1e-10)
    if white_back:
        rgb = rgb + 1 - weight_total
    return rgb * 2 - 1, depth, weights


def ray_march_plain(colors: torch.Tensor, densities: torch.Tensor,
                    depths: torch.Tensor, *, white_back: bool = False):
    """The plain PyTorch version of MipRayMarcher2 (softplus clamp).

    colors (B, R, N, C), densities and depths (B, R, N, 1) → (rgb (B, R, C)
    in [-1, 1], depth (B, R, 1), weights (B, R, N−1, 1)). Depth is clipped
    to the whole batch's depth range, as in the JAX package."""
    rgb, depth, weights = _march_unclipped(colors, densities, depths,
                                           white_back)
    return rgb, depth.clamp(depths.min(), depths.max()), weights


def ray_march_backward_plain(colors: torch.Tensor, densities: torch.Tensor,
                             depths: torch.Tensor,
                             g_rgb: torch.Tensor | None = None,
                             g_depth: torch.Tensor | None = None,
                             g_weights: torch.Tensor | None = None):
    """The plain PyTorch version of the backward kernel: (d colors,
    d densities) of the marcher before its depth clip, for the cotangents
    of rgb (B, R, C), unclipped depth (B, R, 1) and weights (B, R, N−1, 1)
    (None: zeros), by autograd."""
    with torch.enable_grad():
        colors = colors.detach().requires_grad_(True)
        densities = densities.detach().requires_grad_(True)
        outs = _march_unclipped(colors, densities, depths.detach(), False)
        pairs = [(o, g) for o, g in zip(outs, (g_rgb, g_depth, g_weights))
                 if g is not None]
        grads = torch.autograd.grad(
            [o for o, _ in pairs], [colors, densities],
            [g for _, g in pairs], allow_unused=True) if pairs \
            else (None, None)
        # the depth and the weights do not depend on the colours
        return tuple(torch.zeros_like(x) if g is None else g
                     for x, g in zip((colors, densities), grads))


def _check_cuda_inputs(fn: str, tensors: dict) -> None:
    """tensors: name → tensor; "colors" (B, R, N, C) sets the device and
    the shapes. Every tensor must be fp32 and contiguous on that device."""
    colors = tensors["colors"]
    b, r, n, _ = colors.shape
    for name in ("densities", "depths"):
        if tensors[name].shape != (b, r, n, 1):
            raise ValueError(f"{fn}: colors {tuple(colors.shape)}, {name} "
                             f"{tuple(tensors[name].shape)}")
    for name, t in tensors.items():
        if t.device != colors.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous fp32 "
                             f"tensor on {colors.device}")
    if b * r >= 2 ** 31:
        raise ValueError(f"{fn}: B·R exceeds the kernel's int32 range")


def _check_backward_inputs(colors, densities, depths, g_rgb, g_depth,
                           g_weights) -> list:
    """`_check_cuda_inputs` for the backward, with the cotangents' shapes;
    → the cotangents in the kernel's order (None: zeros)."""
    b, r, n, c = colors.shape
    cots = {"g_rgb": (g_rgb, (b, r, c)), "g_depth": (g_depth, (b, r, 1)),
            "g_weights": (g_weights, (b, r, max(n - 1, 0), 1))}
    for name, (g, shape) in cots.items():
        if g is not None and g.shape != shape:
            raise ValueError(f"ray_march_backward: {name} {tuple(g.shape)}, "
                             f"expected {shape}")
    _check_cuda_inputs("ray_march_backward", {
        "colors": colors, "densities": densities, "depths": depths,
        **{k: g for k, (g, _) in cots.items() if g is not None}})
    return [g for g, _ in cots.values()]


def scratch_warps_for(rays: int, n: int) -> int:
    """Warps of the backward kernel's scratch buffer for `rays` rays of n
    samples: 0 while its general path's 7·n floats a warp fit in shared
    memory (the fast path, N ≤ 1024, never needs one), else up to
    SCRATCH_WARPS, a multiple of the kernel's 8 warps a block."""
    if n <= GENERAL_SHARED_SAMPLES:
        return 0
    return min(SCRATCH_WARPS, -(-rays // 8) * 8)


def add_white_back(rgb: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """rgb + 2·(1 − Σw): `ray_march_plain(..., white_back=True)`'s white
    background on the outputs of a march without it (rgb already 2·x − 1,
    weights (B, R, N−1, 1))."""
    return rgb + 2 * (1 - weights.sum(dim=2))


def ray_march_backward(colors: torch.Tensor, densities: torch.Tensor,
                       depths: torch.Tensor,
                       g_rgb: torch.Tensor | None = None,
                       g_depth: torch.Tensor | None = None,
                       g_weights: torch.Tensor | None = None):
    """Same contract as `ray_march_backward_plain`. A CPU tensor goes to
    the plain version; a CUDA tensor launches the backward kernel (fp32,
    contiguous) or raises."""
    if colors.device.type == "cpu":
        return ray_march_backward_plain(colors, densities, depths, g_rgb,
                                        g_depth, g_weights)
    if colors.device.type != "cuda":
        raise ValueError(f"ray_march_backward: unsupported device "
                         f"{colors.device}")
    b, r, n, c = colors.shape
    cots = _check_backward_inputs(colors, densities, depths, g_rgb, g_depth,
                                  g_weights)
    d_colors = torch.empty_like(colors)
    d_densities = torch.empty_like(densities)
    scratch, scratch_warps = None, scratch_warps_for(b * r, n)
    if scratch_warps:
        scratch = torch.empty(scratch_warps * 7 * n, dtype=torch.float32,
                              device=colors.device)
    lib = build.library()
    global LAUNCHES_BWD
    with torch.cuda.device(colors.device):
        err = lib.hfa_ray_march_bwd(
            colors.data_ptr(), densities.data_ptr(), depths.data_ptr(),
            *(None if g is None else g.data_ptr() for g in cots),
            d_colors.data_ptr(), d_densities.data_ptr(),
            None if scratch is None else scratch.data_ptr(), scratch_warps,
            b * r, n, c, torch.cuda.current_stream().cuda_stream)
    build.check(err, "hfa_ray_march_bwd")
    LAUNCHES_BWD += 1
    return d_colors, d_densities


def _launch_forward(colors: torch.Tensor, densities: torch.Tensor,
                    depths: torch.Tensor):
    """→ (rgb, unclipped depth, weights) from the forward kernel."""
    _check_cuda_inputs("ray_march", {"colors": colors, "densities": densities,
                                     "depths": depths})
    b, r, n, c = colors.shape
    dev = colors.device
    rgb = torch.empty((b, r, c), dtype=torch.float32, device=dev)
    depth = torch.empty((b, r, 1), dtype=torch.float32, device=dev)
    weights = torch.empty((b, r, max(n - 1, 0), 1), dtype=torch.float32,
                          device=dev)
    lib = build.library()
    global LAUNCHES
    with torch.cuda.device(dev):
        err = lib.hfa_ray_march(
            colors.data_ptr(), densities.data_ptr(), depths.data_ptr(),
            rgb.data_ptr(), depth.data_ptr(), weights.data_ptr(), b * r, n,
            c, torch.cuda.current_stream().cuda_stream)
    build.check(err, "hfa_ray_march")
    LAUNCHES += 1
    return rgb, depth, weights


class _RayMarch(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient (colors
    and densities; depths get none)."""

    @staticmethod
    def forward(ctx, colors, densities, depths):
        ctx.save_for_backward(colors, densities, depths)
        ctx.set_materialize_grads(False)
        return _launch_forward(colors, densities, depths)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_rgb, g_depth, g_weights):
        d_colors, d_densities = ray_march_backward(
            *ctx.saved_tensors,
            *(None if g is None else g.contiguous()
              for g in (g_rgb, g_depth, g_weights)))
        return d_colors, d_densities, None


def ray_march(colors: torch.Tensor, densities: torch.Tensor,
              depths: torch.Tensor, *, white_back: bool = False):
    """Same contract as `ray_march_plain`, differentiable in `colors` and
    `densities`.

    A CPU tensor goes to the plain version; a CUDA tensor launches the
    kernels (fp32, contiguous) or raises. On CUDA `depths` must not
    require a gradient: the kernels give none, and a silent zero would
    train differently from the CPU. `white_back` adds 2·(1 − Σw) to rgb as
    torch ops on the kernel's weights (the JAX renderer's own path), so
    autograd hands that term to the backward kernel as the weights'
    cotangent."""
    if colors.device.type == "cpu":
        return ray_march_plain(colors, densities, depths,
                               white_back=white_back)
    if colors.device.type != "cuda":
        raise ValueError(f"ray_march: unsupported device {colors.device}")
    if depths.requires_grad:
        raise ValueError("ray_march: the CUDA kernels give no gradient to "
                         "depths; detach them")
    rgb, depth, weights = _RayMarch.apply(colors, densities, depths)
    if white_back:
        rgb = add_white_back(rgb, weights)
    lo, hi = torch.aminmax(depths)          # one pass, not two
    return rgb, depth.clamp(lo, hi), weights
