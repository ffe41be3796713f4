"""EG3D importance renderer in PyTorch (port of
hfa_gp_tpu/models/eg3d/renderer.py), in the direct form.

Coarse pass: stratified depths → tri-plane sampler kernel → OSG decoder →
ray-march kernel. Fine pass: importance depths from the coarse weights →
the same two kernels on the depth-sorted union of both sample sets.

The JAX package's TPU workarounds are not ported: packed planes, slabs and
block plans, the masked-reduction searchsorted, the one-hot rank merge and
the triangular-matmul transmittance. Here they are
`core.kernels.triplane.sample_mean`, `torch.searchsorted`, a stable
`torch.sort` with a gather, and the marcher's running product. The exact
per-plane lookup, `sample_from_planes`, lives beside the sampler kernel
as its plain version.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ...core import ops
from ...core.kernels import raymarch, triplane


@dataclass(frozen=True)
class RenderConfig:
    """rendering_kwargs of the ffhqrebalanced512-128 config."""
    ray_start: float = 2.25
    ray_end: float = 3.3
    box_warp: float = 1.0
    depth_resolution: int = 48
    depth_resolution_importance: int = 48
    neural_rendering_resolution: int = 128
    decoder_lr_mul: float = 1.0
    decoder_hidden: int = 64
    decoder_output_dim: int = 32
    white_back: bool = False            # True raises on CUDA (marcher)
    # Fine placement: "stratified" (the JAX chip path's default) places
    # sampler_depth_window samples at CDF quantiles inside each static
    # depth window (sample_importance_windowed); "global" places all
    # samples at global CDF quantiles (sample_importance, the reference).
    sampler_fine: str = "stratified"
    sampler_depth_window: int = 4


# -- OSG decoder ---------------------------------------------------------------


def init_decoder(g: torch.Generator, cfg: RenderConfig,
                 n_features: int = 32) -> dict:
    def randn(*shape):
        return torch.randn(shape, generator=g) / cfg.decoder_lr_mul
    return {
        "fc0": {"weight": randn(cfg.decoder_hidden, n_features),
                "bias": torch.zeros(cfg.decoder_hidden)},
        "fc1": {"weight": randn(1 + cfg.decoder_output_dim,
                                cfg.decoder_hidden),
                "bias": torch.zeros(1 + cfg.decoder_output_dim)},
    }


def decoder_apply(params, cfg: RenderConfig, features: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plane-AVERAGED features (B, M, C) → (rgb (B, M, 32), sigma (B, M, 1)).

    The JAX function takes the (B, 3, M, C) per-plane features and
    averages them first; here the sampler kernel has averaged already."""
    x = ops.fully_connected(features, params["fc0"]["weight"],
                            params["fc0"]["bias"],
                            lr_multiplier=cfg.decoder_lr_mul)
    x = F.softplus(x)
    x = ops.fully_connected(x, params["fc1"]["weight"], params["fc1"]["bias"],
                            lr_multiplier=cfg.decoder_lr_mul)
    sigma = x[..., 0:1]
    rgb = torch.sigmoid(x[..., 1:]) * (1 + 2 * 0.001) - 0.001
    return rgb, sigma


# -- depth sampling ------------------------------------------------------------


def sample_stratified(ray_origins: torch.Tensor, ray_start: float,
                      ray_end: float, depth_resolution: int,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
    """(B, R, 3) → (B, R, N, 1) depths; without a generator the samples
    sit at the bin starts (deterministic inference)."""
    b, r, _ = ray_origins.shape
    n = depth_resolution
    dev = ray_origins.device
    depths = torch.linspace(ray_start, ray_end, n, device=dev)
    depths = depths[None, None, :, None].expand(b, r, n, 1)
    if generator is not None:
        delta = (ray_end - ray_start) / (n - 1)
        depths = depths + torch.rand((b, r, n, 1), generator=generator,
                                     device=generator.device).to(dev) * delta
    return depths


def _smooth_weights(weights: torch.Tensor) -> torch.Tensor:
    """max_pool1d(k=2, s=1, p=1) → avg_pool1d(k=2, s=1) → + 0.01."""
    m = F.max_pool1d(weights[:, None], 2, 1, padding=1)
    return F.avg_pool1d(m, 2, 1)[:, 0] + 0.01


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_importance: int,
               generator: torch.Generator | None = None, eps: float = 1e-5,
               u: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse-CDF sampling. bins (N, K ≥ L + 1), weights (N, L) → (N,
    n_importance); the CDF spans the first L + 1 bins. u defaults to
    linspace(0, 1) (deterministic) or uniform draws from `generator`."""
    n_rays, n_w = weights.shape
    weights = weights + eps
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)],
                    dim=-1)
    if u is None:
        if generator is None:
            u = torch.linspace(0.0, 1.0, n_importance, device=bins.device)
            u = u.expand(n_rays, n_importance)
        else:
            u = torch.rand((n_rays, n_importance), generator=generator,
                           device=generator.device).to(bins.device)
    u = u.contiguous()
    inds = torch.searchsorted(cdf, u, right=True)
    below = (inds - 1).clamp_min(0)
    above = inds.clamp_max(n_w)
    bins = bins[:, :n_w + 1]
    cdf_lo, cdf_hi = cdf.gather(1, below), cdf.gather(1, above)
    bin_lo, bin_hi = bins.gather(1, below), bins.gather(1, above)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bin_lo + (u - cdf_lo) / denom * (bin_hi - bin_lo)


def sample_importance(z_vals: torch.Tensor, weights: torch.Tensor,
                      n_importance: int,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
    """Global-quantile fine depths: z_vals (B, R, N, 1), coarse weights
    (B, R, N−1, 1) → (B, R, n_importance, 1), sorted per ray."""
    b, r, n, _ = z_vals.shape
    z = z_vals.reshape(b * r, n)
    w = _smooth_weights(weights.reshape(b * r, -1))
    z_mid = 0.5 * (z[:, :-1] + z[:, 1:])
    fine = sample_pdf(z_mid, w[:, 1:-1], n_importance, generator=generator)
    if generator is not None:
        fine = torch.sort(fine, dim=-1).values
    # no gradient through the sample placement (JAX: stop_gradient)
    return fine.detach().reshape(b, r, n_importance, 1)


def _eval_cdf(bins: torch.Tensor, cdf: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Piecewise-linear CDF F(x) on nondecreasing bins (N, K) with values
    cdf (N, K), at queries x (N, Q); constant outside the bins."""
    k = bins.shape[1]
    idx = torch.searchsorted(bins.contiguous(), x.contiguous(), right=True)
    lo = (idx - 1).clamp_min(0)
    hi = idx.clamp_max(k - 1)
    bin_lo, bin_hi = bins.gather(1, lo), bins.gather(1, hi)
    cdf_lo, cdf_hi = cdf.gather(1, lo), cdf.gather(1, hi)
    span = bin_hi - bin_lo
    denom = torch.where(span < eps, torch.ones_like(span), span)
    t = ((x - bin_lo) / denom).clamp(0.0, 1.0)
    return cdf_lo + t * (cdf_hi - cdf_lo)


def sample_importance_windowed(z_vals: torch.Tensor, weights: torch.Tensor,
                               n_windows: int, n_per: int, ray_start: float,
                               ray_end: float,
                               generator: torch.Generator | None = None
                               ) -> torch.Tensor:
    """Windowed stratified fine depths: each of n_windows static depth
    windows gets n_per samples at CDF quantiles inside the window (the JAX
    chip path's placement). → (B, R, n_windows·n_per, 1), sorted per ray."""
    b, r, n, _ = z_vals.shape
    nr = b * r
    dev = z_vals.device
    z = z_vals.reshape(nr, n)
    w = _smooth_weights(weights.reshape(nr, -1))[:, 1:-1]
    z_mid = 0.5 * (z[:, :-1] + z[:, 1:])

    eps = 1e-5
    ww = w + eps
    pdf = ww / ww.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)],
                    dim=-1)
    bins = z_mid[:, :cdf.shape[1]]

    edges = torch.linspace(ray_start, ray_end, n_windows + 1, device=dev)
    f_edges = _eval_cdf(bins, cdf, edges.expand(nr, n_windows + 1))
    f_lo = f_edges[:, :-1, None]
    f_hi = f_edges[:, 1:, None]
    strata = torch.arange(n_per, device=dev, dtype=torch.float32)
    if generator is None:
        frac = ((strata + 0.5) / n_per)[None, None, :]
    else:
        jitter = torch.rand((nr, n_windows, n_per), generator=generator,
                            device=generator.device).to(dev)
        frac = (strata + jitter) / n_per
    u = (f_lo + frac * (f_hi - f_lo)).reshape(nr, n_windows * n_per)
    fine = sample_pdf(bins, w, n_windows * n_per, u=u)
    # no gradient through the sample placement (JAX: stop_gradient)
    return fine.detach().reshape(b, r, n_windows * n_per, 1)


# -- compositing ----------------------------------------------------------------


def ray_march(colors: torch.Tensor, densities: torch.Tensor,
              depths: torch.Tensor, cfg: RenderConfig):
    """MipRayMarcher2 (softplus density clamp) through the marcher
    kernel's wrapper → (rgb (B,R,C) in [-1, 1], depth (B,R,1), weights
    (B,R,N−1,1))."""
    return raymarch.ray_march(colors.contiguous(), densities.contiguous(),
                              depths.contiguous(), white_back=cfg.white_back)


def unify_samples(d1, c1, s1, d2, c2, s2):
    """Depth-sorted union of two sample lists (B, R, N_i, ·): one stable
    sort of the concatenated depths, then a gather; on equal depths list 1
    comes first, as in the JAX rank merge."""
    depths = torch.cat([d1, d2], dim=-2)
    colors = torch.cat([c1, c2], dim=-2)
    sigmas = torch.cat([s1, s2], dim=-2)
    order = torch.sort(depths[..., 0], dim=-1, stable=True).indices[..., None]
    return (depths.gather(2, order),
            colors.gather(2, order.expand(-1, -1, -1, colors.shape[-1])),
            sigmas.gather(2, order))


# -- importance renderer -------------------------------------------------------------


def render_rays(decoder_params, cfg: RenderConfig, planes: torch.Tensor,
                ray_origins: torch.Tensor, ray_directions: torch.Tensor,
                generator: torch.Generator | None = None,
                ray_grid: tuple[int, int] | None = None):
    """planes (B, 3, H, W, C); rays (B, R, 3) → (features (B, R, 32),
    depth (B, R, 1), weight sum (B, R, 1)). Two sampler launches and two
    marcher launches per call when depth_resolution_importance > 0. Under
    autograd the backward launches the sampler's backward kernel twice and
    the marcher's once: the coarse march feeds only the detached fine
    depths, so its backward never runs. `ray_grid` (h, w), optional: the
    rays are an h × w image, row-major (`camera.generate_rays`); the
    sampler's backward kernel then sums neighbouring rays' samples
    together. It changes no result."""
    b, r, _ = ray_origins.shape
    planes = planes.contiguous()

    def eval_points(depths):
        n = depths.shape[2]
        pts = ray_origins[:, :, None, :] + depths * ray_directions[:, :, None]
        feats = triplane.sample_mean(
            planes, pts.reshape(b, -1, 3), cfg.box_warp,
            layout=None if ray_grid is None else (*ray_grid, n))
        rgb, sigma = decoder_apply(decoder_params, cfg, feats)
        return rgb.reshape(b, r, n, -1), sigma.reshape(b, r, n, 1)

    depths_coarse = sample_stratified(ray_origins, cfg.ray_start, cfg.ray_end,
                                      cfg.depth_resolution,
                                      generator=generator)
    colors_c, densities_c = eval_points(depths_coarse)

    n_fine = cfg.depth_resolution_importance
    if n_fine == 0:
        rgb, depth, weights = ray_march(colors_c, densities_c, depths_coarse,
                                        cfg)
        return rgb, depth, weights.sum(2)

    _, _, weights = ray_march(colors_c, densities_c, depths_coarse, cfg)
    if cfg.sampler_fine == "stratified":
        if n_fine % cfg.sampler_depth_window:
            raise ValueError(
                f"depth_resolution_importance ({n_fine}) must be a multiple "
                f"of sampler_depth_window ({cfg.sampler_depth_window})")
        depths_fine = sample_importance_windowed(
            depths_coarse, weights, n_windows=n_fine // cfg.sampler_depth_window,
            n_per=cfg.sampler_depth_window, ray_start=cfg.ray_start,
            ray_end=cfg.ray_end, generator=generator)
    elif cfg.sampler_fine == "global":
        depths_fine = sample_importance(depths_coarse, weights, n_fine,
                                        generator=generator)
    else:
        raise ValueError(f"sampler_fine {cfg.sampler_fine!r}")
    colors_f, densities_f = eval_points(depths_fine)
    depths, colors, densities = unify_samples(
        depths_coarse, colors_c, densities_c, depths_fine, colors_f,
        densities_f)
    rgb, depth, weights = ray_march(colors, densities, depths, cfg)
    return rgb, depth, weights.sum(2)
