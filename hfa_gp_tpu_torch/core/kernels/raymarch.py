"""Ray marcher: dispatching wrapper, plain version and launch count.

Replaces the TPU kernel `hfa_gp_tpu/core/pallas/raymarch.py::
_march_kernel` (via `pallas_ray_march`). The kernel is `csrc/raymarch.cu`;
its header says what bounds it on the H100 (memory: one read of the
colours) and how the design answers that. The JAX package leaves its
kernel off by default; the port runs its kernel on both passes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

# Launches of the CUDA kernel in this process (see `ray_march`).
LAUNCHES = 0


def ray_march_plain(colors: torch.Tensor, densities: torch.Tensor,
                    depths: torch.Tensor, *, white_back: bool = False):
    """The plain PyTorch version of MipRayMarcher2 (softplus clamp).

    colors (B, R, N, C), densities and depths (B, R, N, 1) → (rgb (B, R, C)
    in [-1, 1], depth (B, R, 1), weights (B, R, N−1, 1)). Depth is clipped
    to the whole batch's depth range, as in the JAX package."""
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
    depth = depth.clamp(depths.min(), depths.max())
    if white_back:
        rgb = rgb + 1 - weight_total
    return rgb * 2 - 1, depth, weights


def ray_march(colors: torch.Tensor, densities: torch.Tensor,
              depths: torch.Tensor, *, white_back: bool = False):
    """Same contract as `ray_march_plain`.

    A CPU tensor goes to the plain version; a CUDA tensor launches the
    kernel (fp32, contiguous, white_back=False) or raises."""
    if colors.device.type == "cpu":
        return ray_march_plain(colors, densities, depths,
                               white_back=white_back)
    if colors.device.type != "cuda":
        raise ValueError(f"ray_march: unsupported device {colors.device}")
    if white_back:
        raise NotImplementedError("ray_march kernel: white_back=True is not "
                                  "supported (the JAX kernel asserts it too)")
    b, r, n, c = colors.shape
    if densities.shape != (b, r, n, 1) or depths.shape != (b, r, n, 1):
        raise ValueError(f"ray_march: colors {tuple(colors.shape)}, "
                         f"densities {tuple(densities.shape)}, "
                         f"depths {tuple(depths.shape)}")
    for name, t in (("colors", colors), ("densities", densities),
                    ("depths", depths)):
        if t.device != colors.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"ray_march: {name} must be a contiguous fp32 "
                             f"tensor on {colors.device}")
    if b * r >= 2 ** 31:
        raise ValueError("ray_march: B·R exceeds the kernel's int32 range")
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
    return rgb, depth.clamp(depths.min(), depths.max()), weights
