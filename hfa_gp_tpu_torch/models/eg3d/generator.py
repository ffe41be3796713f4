"""TriPlaneGenerator in PyTorch (port of
hfa_gp_tpu/models/eg3d/generator.py).

    out = synthesis(params, cfg, ws, c)      # ws (B, 14, 512), c (B, 25)
    out["image"]       (B, 512, 512, 3)  in [-1, 1]
    out["image_raw"]   (B, 128, 128, 3)
    out["image_depth"] (B, 128, 128, 1)

`c` is a label in the OpenCV convention. Outputs keep the JAX layout
(channel-last) and the dtype of ws (fp32); the networks run NCHW inside,
their synthesis chains in `compute_dtype` (bf16 under `--bf16`; None keeps
the params' dtype).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ...core import camera as cam
from ...core import graphs
from ...core.kernels import triplane
from ...parallel import mesh as mesh_mod
from ...utils.observability import annotate
from . import networks as nets
from . import renderer as rnd


@dataclass(frozen=True)
class EG3DConfig:
    mapping: nets.MappingConfig = field(default_factory=nets.MappingConfig)
    backbone: nets.BackboneConfig = field(default_factory=nets.BackboneConfig)
    sr: nets.SRConfig = field(default_factory=nets.SRConfig)
    render: rnd.RenderConfig = field(default_factory=rnd.RenderConfig)
    compute_dtype: torch.dtype | None = None

    @property
    def num_ws(self) -> int:
        return self.backbone.num_ws

    @property
    def plane_channels(self) -> int:
        return self.backbone.img_channels // 3


def init_generator(g: torch.Generator, cfg: EG3DConfig) -> dict:
    """Random generator params from `g`, as a nested dict of CPU tensors
    (wrap with `utils.convert.ParamTree` and move to a device)."""
    return {
        "mapping": nets.init_mapping(g, cfg.mapping),
        "backbone": nets.init_backbone(g, cfg.backbone),
        "decoder": rnd.init_decoder(g, cfg.render, cfg.plane_channels),
        "superresolution": nets.init_superresolution(g, cfg.sr),
    }


def mapping(params, cfg: EG3DConfig, z: torch.Tensor,
            c: torch.Tensor | None, truncation_psi: float = 1.0, *,
            update_emas: bool = False, w_avg_beta: float = 0.995
            ) -> torch.Tensor:
    return nets.mapping_apply(params["mapping"], cfg.mapping, cfg.num_ws, z,
                              c, truncation_psi, update_emas=update_emas,
                              w_avg_beta=w_avg_beta)


def _rays(_, c: torch.Tensor, res: int):
    cam2world, intrinsics = cam.unpack_label(c)
    return cam.generate_rays(cam2world, intrinsics, res)


def _backbone(params, ws: torch.Tensor, cfg: EG3DConfig, noise_mode: str,
              noise_generator: torch.Generator | None = None):
    planes = nets.backbone_apply(params, cfg.backbone, ws,
                                 noise_mode=noise_mode,
                                 compute_dtype=cfg.compute_dtype,
                                 generator=noise_generator)
    b, _, h, w = planes.shape
    planes = planes.reshape(b, 3, cfg.plane_channels, h, w)
    return planes.permute(0, 1, 3, 4, 2)                # (B, 3, H, W, C)


def _render(params, planes: torch.Tensor, ray_origins: torch.Tensor,
            ray_directions: torch.Tensor, cfg: rnd.RenderConfig, res: int,
            generator: torch.Generator | None = None, mesh=None):
    """→ (feature image (B, 32, res, res), depth (B, res, res, 1))."""
    b = planes.shape[0]
    feature_samples, depth_samples, _ = rnd.render_rays(
        params, cfg, planes, ray_origins, ray_directions,
        generator=generator, ray_grid=(res, res), mesh=mesh)
    return (feature_samples.permute(0, 2, 1).reshape(b, -1, res, res),
            depth_samples.reshape(b, res, res, 1))


def _superres(params, feature_image: torch.Tensor, ws: torch.Tensor,
              cfg: EG3DConfig):
    return nets.superresolution_apply(
        params, cfg.sr, feature_image[:, :3], feature_image, ws,
        noise_mode="none", compute_dtype=cfg.compute_dtype)


def synthesis(params, cfg: EG3DConfig, ws: torch.Tensor, c: torch.Tensor, *,
              noise_mode: str = "const",
              render_generator: torch.Generator | None = None,
              neural_rendering_resolution: int | None = None,
              mesh=None,
              noise_generator: torch.Generator | None = None
              ) -> dict[str, torch.Tensor]:
    """ws (B, num_ws, 512) W+ latents; c (B, 25) OpenCV label.

    noise_mode "const" or "none", or "random" (GAN training) with the
    backbone's noise drawn from `noise_generator`; `render_generator`
    draws the depth jitter (None: deterministic, the inference path).
    With a model axis on `mesh` the ranks of its model group split each
    image's rays (`renderer.render_rays`), which come back whole before
    the feature image is formed; everything else runs replicated on each
    rank. The three stages are the profiler ranges "backbone", "render"
    and "superres" (`utils.observability.annotate`). Without a generator
    or a model axis, the rays and each of the three stages replay as a
    CUDA graph where `core.graphs` holds them (on the card, autograd
    off)."""
    res = neural_rendering_resolution or cfg.render.neural_rendering_resolution
    graphed = render_generator is None and noise_generator is None \
        and not mesh_mod.ray_shard(mesh)
    ray_origins, ray_directions = graphs.run("rays", _rays, None, c,
                                             static=(res,), enabled=graphed)
    with annotate("backbone"):
        planes = graphs.run("backbone", _backbone, params["backbone"], ws,
                            static=(cfg, noise_mode, noise_generator),
                            enabled=graphed)
    with annotate("render"):
        feature_image, depth_image = graphs.run(
            "render", _render, params["decoder"], planes, ray_origins,
            ray_directions, enabled=graphed,
            static=(cfg.render, res) if graphed
            else (cfg.render, res, render_generator, mesh))
    with annotate("superres"):
        sr_image = graphs.run("superres", _superres,
                              params["superresolution"], feature_image, ws,
                              static=(cfg,), enabled=graphed)
    return {"image": sr_image.permute(0, 2, 3, 1),
            "image_raw": feature_image[:, :3].permute(0, 2, 3, 1),
            "image_depth": depth_image}


def planes(params, cfg: EG3DConfig, ws: torch.Tensor, *,
           noise_mode: str = "const",
           noise_generator: torch.Generator | None = None) -> torch.Tensor:
    """ws → the tri-planes (B, 3, H, W, C) alone, inside the "backbone"
    span, eagerly (GAN training's density regulariser)."""
    with annotate("backbone"):
        return _backbone(params["backbone"], ws, cfg, noise_mode,
                         noise_generator)


def sample_mixed(params, cfg: EG3DConfig, planes_: torch.Tensor,
                 points: torch.Tensor) -> torch.Tensor:
    """σ, the decoder's raw density, at points (B, M, 3) anywhere in the
    box: the sampler kernel's plane average (K1; K2 in the backward), then
    the decoder → (B, M, 1). EG3D's `sample_mixed` after its backbone."""
    feats = triplane.sample_mean(planes_.contiguous(), points.contiguous(),
                                 cfg.render.box_warp)
    _, sigma = rnd.decoder_apply(params["decoder"], cfg.render, feats)
    return sigma
