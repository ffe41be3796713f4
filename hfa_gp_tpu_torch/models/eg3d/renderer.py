"""EG3D importance renderer in PyTorch (port of
hfa_gp_tpu/models/eg3d/renderer.py), in the direct form.

Coarse pass: stratified depths → tri-plane sampler kernel → OSG decoder →
ray-march kernel. Fine pass: importance depths from the coarse weights →
the same two kernels on the depth-sorted union of both sample sets. Where
no gradient is wanted (`decoder_fused`), the sampler kernel runs the
decoder itself (`triplane.sample_decode`), and only colours and densities
reach device memory.

The JAX package's TPU workarounds are not ported: packed planes, slabs and
block plans, the masked-reduction searchsorted, the one-hot rank merge and
the triangular-matmul transmittance. Here they are
`core.kernels.triplane.sample_mean`, `torch.searchsorted`, a stable
`torch.sort` with a gather, and the marcher's running product. The exact
per-plane lookup, `sample_from_planes`, lives beside the sampler kernel
as its plain version.

`RenderConfig.ray_chunk` renders the rays in chunks, one after the other,
each with its own depth clip, as the JAX package's `lax.map` does;
`remat` recomputes the point evaluations (sampler + decoder) in the
backward instead of keeping their activations. The depth jitter of a
`generator` is drawn once for the whole batch before either, so the
recomputed forward sees the same depths and a chunked render the same
jitter as an unchunked one.

`render_rays(..., mesh=...)` with a model axis (`mesh.n_model` = M > 1)
splits each image's R rays over the ranks of the model group, as the JAX
package's `RenderConfig.ray_shard_axis` does: rank m renders rays
[m·R/M, (m+1)·R/M) from the replicated planes and decoder, with its share
of the jitter that one rank draws for all the rays, clips its depths to
the range of the whole call (an all-reduce over the group), and the
outputs are gathered back to all R rays on every rank
(`parallel.mesh.gather_rays`; the gradients of the planes and the decoder
are summed over the group, `parallel.mesh.into_render`). It gives what one
rank rendering all the rays gives.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...core.kernels import raymarch, triplane
from ...parallel import mesh as mesh_mod


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
    white_back: bool = False            # 2·(1 − Σw) added to rgb
    # Fine placement: "stratified" (the JAX chip path's default) places
    # sampler_depth_window samples at CDF quantiles inside each static
    # depth window (sample_importance_windowed); "global" places all
    # samples at global CDF quantiles (sample_importance, the reference).
    sampler_fine: str = "stratified"
    sampler_depth_window: int = 4
    # the OSG decoder's dtype: it casts the plane-averaged features to it
    # and its 33-channel output back (bf16 under --bf16; None: no cast)
    decoder_dtype: torch.dtype | None = None
    # rays a chunk, rendered one chunk after another (must divide the ray
    # count); None: all rays at once
    ray_chunk: int | None = None
    # recompute each pass's point evaluation in the backward (with
    # ray_chunk: the whole chunk) instead of keeping its activations
    remat: bool = False


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
    """Plane-AVERAGED features (B, M, C) → (rgb (B, M, 32), sigma (B, M, 1))
    in the features' dtype (fp32); the two layers run in
    `cfg.decoder_dtype`.

    The JAX function takes the (B, 3, M, C) per-plane features and
    averages them first; here the sampler kernel has averaged already."""
    x = features if cfg.decoder_dtype is None \
        else features.to(cfg.decoder_dtype)
    return triplane.decode_plain(params, cfg.decoder_lr_mul, x,
                                 out_dtype=features.dtype)


# the devices on which `eval_points` may take the fused sampler + decoder
_FUSED_DEVICES = ("cuda",)


def decoder_fused(cfg: RenderConfig, planes: torch.Tensor,
                  points: torch.Tensor, decoder_params,
                  remat_points: bool) -> bool:
    """Whether a pass's point evaluation takes `triplane.sample_decode`
    (the sampler with the decoder fused) instead of `sample_mean` →
    `decoder_apply`: fp32 planes on the card, the decoder in the
    features' dtype, no gradient wanted of the planes, the points or a
    decoder leaf, no recomputation in the backward, and the widths the
    kernel is built for. Training keeps the two steps, whose backward needs
    the hidden layer."""
    leaves = triplane.decoder_leaves(decoder_params)
    return (planes.device.type in _FUSED_DEVICES
            and planes.dtype == torch.float32
            and cfg.decoder_dtype is None and not remat_points
            and not (torch.is_grad_enabled() and any(
                t.requires_grad for t in (planes, points, *leaves)))
            and triplane.decodes(planes, decoder_params))


# -- depth sampling ------------------------------------------------------------


def sample_stratified(ray_origins: torch.Tensor, ray_start: float,
                      ray_end: float, depth_resolution: int,
                      jitter: torch.Tensor | None = None) -> torch.Tensor:
    """(B, R, 3) → (B, R, N, 1) depths, each moved into its bin by `jitter`
    (B, R, N, 1) of uniform draws; without it the samples sit at the bin
    starts (deterministic inference)."""
    b, r, _ = ray_origins.shape
    n = depth_resolution
    dev = ray_origins.device
    depths = torch.linspace(ray_start, ray_end, n, device=dev)
    depths = depths[None, None, :, None].expand(b, r, n, 1)
    if jitter is not None:
        depths = depths + jitter * ((ray_end - ray_start) / (n - 1))
    return depths


def _smooth_weights(weights: torch.Tensor) -> torch.Tensor:
    """max_pool1d(k=2, s=1, p=1) → avg_pool1d(k=2, s=1) → + 0.01."""
    m = F.max_pool1d(weights[:, None], 2, 1, padding=1)
    return F.avg_pool1d(m, 2, 1)[:, 0] + 0.01


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_importance: int,
               eps: float = 1e-5, u: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Inverse-CDF sampling. bins (N, K ≥ L + 1), weights (N, L) → (N,
    n_importance); the CDF spans the first L + 1 bins, at the quantiles u
    (N, n_importance), linspace(0, 1) without them (deterministic)."""
    n_rays, n_w = weights.shape
    weights = weights + eps
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)],
                    dim=-1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n_importance, device=bins.device)
        u = u.expand(n_rays, n_importance)
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
                      u: torch.Tensor | None = None) -> torch.Tensor:
    """Global-quantile fine depths: z_vals (B, R, N, 1), coarse weights
    (B, R, N−1, 1) → (B, R, n_importance, 1), sorted per ray; at the
    quantiles `u` (B·R, n_importance) of uniform draws when given, else
    evenly spaced."""
    b, r, n, _ = z_vals.shape
    z = z_vals.reshape(b * r, n)
    w = _smooth_weights(weights.reshape(b * r, -1))
    z_mid = 0.5 * (z[:, :-1] + z[:, 1:])
    fine = sample_pdf(z_mid, w[:, 1:-1], n_importance, u=u)
    if u is not None:
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
                               jitter: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Windowed stratified fine depths: each of n_windows static depth
    windows gets n_per samples at CDF quantiles inside the window (the JAX
    chip path's placement), jittered by `jitter` (B·R, n_windows, n_per)
    of uniform draws when given, else at the strata's centres.
    → (B, R, n_windows·n_per, 1), sorted per ray."""
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
    if jitter is None:
        frac = ((strata + 0.5) / n_per)[None, None, :]
    else:
        frac = (strata + jitter) / n_per
    u = (f_lo + frac * (f_hi - f_lo)).reshape(nr, n_windows * n_per)
    fine = sample_pdf(bins, w, n_windows * n_per, u=u)
    # no gradient through the sample placement (JAX: stop_gradient)
    return fine.detach().reshape(b, r, n_windows * n_per, 1)


# -- compositing ----------------------------------------------------------------


def ray_march(colors: torch.Tensor, densities: torch.Tensor,
              depths: torch.Tensor, cfg: RenderConfig, mesh=None):
    """MipRayMarcher2 (softplus density clamp) through the marcher
    kernel's wrapper → (rgb (B,R,C) in [-1, 1], depth (B,R,1), weights
    (B,R,N−1,1)). With a model axis on `mesh`, these rays are this rank's
    share, and the depth is clipped to the range of every rank's depths."""
    depth_range = None
    if mesh_mod.ray_shard(mesh):
        depth_range = mesh_mod.model_min_max(*torch.aminmax(depths), mesh)
    return raymarch.ray_march(colors.contiguous(), densities.contiguous(),
                              depths.contiguous(), white_back=cfg.white_back,
                              depth_range=depth_range)


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


def _check_fine(cfg: RenderConfig) -> None:
    if cfg.sampler_fine not in ("stratified", "global"):
        raise ValueError(f"sampler_fine {cfg.sampler_fine!r}")
    if cfg.sampler_fine == "stratified" \
            and cfg.depth_resolution_importance % cfg.sampler_depth_window:
        raise ValueError(
            f"depth_resolution_importance "
            f"({cfg.depth_resolution_importance}) must be a multiple of "
            f"sampler_depth_window ({cfg.sampler_depth_window})")


def _draw_jitter(cfg: RenderConfig, b: int, r: int,
                 generator: torch.Generator | None, dev):
    """(coarse (B, R, N, 1), fine (B, R, ...)) uniform draws of a render
    from `generator` (on its own device), moved to dev; (None, None)
    without one. Fine: (B, R, n_windows, n_per) for the stratified
    placement, (B, R, n_fine) for the global one."""
    if generator is None:
        return None, None

    def uniform(*shape):
        return torch.rand(shape, generator=generator,
                          device=generator.device).to(dev)

    coarse = uniform(b, r, cfg.depth_resolution, 1)
    n_fine = cfg.depth_resolution_importance
    if n_fine == 0:
        return coarse, None
    if cfg.sampler_fine == "stratified":
        w = cfg.sampler_depth_window
        return coarse, uniform(b, r, n_fine // w, w)
    return coarse, uniform(b, r, n_fine)


def _render_core(decoder_params, cfg: RenderConfig, planes: torch.Tensor,
                 ray_origins: torch.Tensor, ray_directions: torch.Tensor,
                 jitter_coarse: torch.Tensor | None,
                 jitter_fine: torch.Tensor | None,
                 ray_grid: tuple[int, int] | None, remat_points: bool,
                 mesh=None):
    """`render_rays` on one set of rays with its jitter drawn already;
    `remat_points` checkpoints each pass's point evaluation. With a model
    axis on `mesh` the last march clips the depth to the range of the
    whole call (the coarse march's depth is not used)."""
    b, r, _ = ray_origins.shape

    def eval_points(depths):
        n = depths.shape[2]
        pts = ray_origins[:, :, None, :] + depths * ray_directions[:, :, None]
        pts = pts.reshape(b, -1, 3)
        layout = None if ray_grid is None else (*ray_grid, n)
        if decoder_fused(cfg, planes, pts, decoder_params, remat_points):
            rgb, sigma = triplane.sample_decode(
                planes, pts, cfg.box_warp, decoder_params,
                cfg.decoder_lr_mul, layout=layout)
        else:
            feats = triplane.sample_mean(planes, pts, cfg.box_warp,
                                         layout=layout)
            rgb, sigma = decoder_apply(decoder_params, cfg, feats)
        return rgb.reshape(b, r, n, -1), sigma.reshape(b, r, n, 1)

    if remat_points:
        def eval_points(depths, _eval=eval_points):
            return checkpoint(_eval, depths, use_reentrant=False,
                              preserve_rng_state=False)

    depths_coarse = sample_stratified(ray_origins, cfg.ray_start, cfg.ray_end,
                                      cfg.depth_resolution,
                                      jitter=jitter_coarse)
    colors_c, densities_c = eval_points(depths_coarse)

    n_fine = cfg.depth_resolution_importance
    if n_fine == 0:
        rgb, depth, weights = ray_march(colors_c, densities_c, depths_coarse,
                                        cfg, mesh)
        return rgb, depth, weights.sum(2)

    _, _, weights = ray_march(colors_c, densities_c, depths_coarse, cfg)
    if cfg.sampler_fine == "stratified":
        depths_fine = sample_importance_windowed(
            depths_coarse, weights, n_windows=n_fine // cfg.sampler_depth_window,
            n_per=cfg.sampler_depth_window, ray_start=cfg.ray_start,
            ray_end=cfg.ray_end, jitter=None if jitter_fine is None
            else jitter_fine.reshape(b * r, *jitter_fine.shape[2:]))
    else:
        depths_fine = sample_importance(
            depths_coarse, weights, n_fine, u=None if jitter_fine is None
            else jitter_fine.reshape(b * r, n_fine))
    colors_f, densities_f = eval_points(depths_fine)
    depths, colors, densities = unify_samples(
        depths_coarse, colors_c, densities_c, depths_fine, colors_f,
        densities_f)
    rgb, depth, weights = ray_march(colors, densities, depths, cfg, mesh)
    return rgb, depth, weights.sum(2)


def _grid_rows(ray_grid: tuple[int, int] | None, n: int):
    """The grid of a run of n consecutive rays of the image `ray_grid`
    (h, w): (n / w, w) when it is whole rows, else None."""
    if ray_grid is None or n % ray_grid[1]:
        return None
    return n // ray_grid[1], ray_grid[1]


def _render_sharded(decoder_params, cfg: RenderConfig, planes, ray_origins,
                    ray_directions, jitter, ray_grid, remat: bool, mesh):
    """`render_rays` with a model axis: this rank's share of the rays,
    gathered back to all of them (see the module's docstring)."""
    b, r, _ = ray_origins.shape
    if cfg.ray_chunk and cfg.ray_chunk < r:
        raise ValueError("ray_chunk with a model axis: ray sharding renders "
                         "each rank's share of the rays at once")
    lo, hi = mesh_mod.ray_range(r, mesh)
    names = [(k, n) for k in ("fc0", "fc1") for n in ("weight", "bias")]
    planes, *leaves = mesh_mod.into_render(
        [planes, *(decoder_params[k][n] for k, n in names)], mesh)
    dec: dict = {"fc0": {}, "fc1": {}}
    for (k, n), t in zip(names, leaves):
        dec[k][n] = t
    mine = [None if t is None else t[:, lo:hi]
            for t in (ray_origins, ray_directions, *jitter)]
    outs = _render_core(dec, cfg, planes, *mine, _grid_rows(ray_grid, hi - lo),
                        remat, mesh)
    # one all-gather for the three outputs
    whole = mesh_mod.gather_rays(torch.cat(outs, dim=-1), mesh)
    return whole.split([t.shape[-1] for t in outs], dim=-1)


def render_rays(decoder_params, cfg: RenderConfig, planes: torch.Tensor,
                ray_origins: torch.Tensor, ray_directions: torch.Tensor,
                generator: torch.Generator | None = None,
                ray_grid: tuple[int, int] | None = None, mesh=None):
    """planes (B, 3, H, W, C); rays (B, R, 3) → (features (B, R, 32),
    depth (B, R, 1), weight sum (B, R, 1)). Two sampler launches and two
    marcher launches per call when depth_resolution_importance > 0. Under
    autograd the backward launches the sampler's backward kernel twice and
    the marcher's once: the coarse march feeds only the detached fine
    depths, so its backward never runs. `ray_grid` (h, w), optional: the
    rays are an h × w image, row-major (`camera.generate_rays`); the
    sampler's backward kernel then sums neighbouring rays' samples
    together. It changes no result.

    With `cfg.ray_chunk` = c < R (c must divide R) the rays render c at a
    time: every launch above happens once a chunk, each chunk's depth is
    clipped to its own depths' range (the JAX package's `lax.map` calls
    its core once a chunk), and a chunk of whole image rows keeps the
    grid. With `cfg.remat` under autograd, the backward recomputes each
    pass's point evaluation (sampler launches: two more a call); chunked,
    it recomputes each whole chunk instead, the marcher included.

    With a model axis on `mesh` (a `parallel.mesh.Mesh`, n_model = M > 1;
    every rank of the model group calls with the same arguments) each rank
    renders R/M of the rays, M must divide R, and the launches above
    happen on each rank on its R/M rays; the result is the whole (B, R, ·)
    on every rank. A shard of whole image rows keeps `ray_grid`.
    `ray_chunk` (< R) together with a model axis raises: no CLI asks for
    both, and JAX's `lax.map` would chunk the global ray index."""
    b, r, _ = ray_origins.shape
    _check_fine(cfg)
    planes = planes.contiguous()
    # the whole call's jitter on every rank: each takes its share of it
    jitter = _draw_jitter(cfg, b, r, generator, ray_origins.device)
    remat = cfg.remat and torch.is_grad_enabled()
    if mesh_mod.ray_shard(mesh):
        return _render_sharded(decoder_params, cfg, planes, ray_origins,
                               ray_directions, jitter, ray_grid, remat, mesh)
    chunk = cfg.ray_chunk
    if not chunk or chunk >= r:
        return _render_core(decoder_params, cfg, planes, ray_origins,
                            ray_directions, *jitter, ray_grid, remat)
    if r % chunk:
        raise ValueError(f"ray_chunk ({chunk}) must divide the ray count "
                         f"({r})")
    grid = _grid_rows(ray_grid, chunk)

    def one(o, d, jc, jf):
        return _render_core(decoder_params, cfg, planes, o, d, jc, jf, grid,
                            False)

    outs = []
    for i in range(0, r, chunk):
        args = [None if t is None else t[:, i:i + chunk]
                for t in (ray_origins, ray_directions, *jitter)]
        outs.append(checkpoint(one, *args, use_reentrant=False,
                               preserve_rng_state=False) if remat
                    else one(*args))
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))
