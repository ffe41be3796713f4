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
            c: torch.Tensor | None, truncation_psi: float = 1.0
            ) -> torch.Tensor:
    return nets.mapping_apply(params["mapping"], cfg.mapping, cfg.num_ws, z,
                              c, truncation_psi)


def synthesis(params, cfg: EG3DConfig, ws: torch.Tensor, c: torch.Tensor, *,
              noise_mode: str = "const",
              render_generator: torch.Generator | None = None,
              neural_rendering_resolution: int | None = None,
              mesh=None) -> dict[str, torch.Tensor]:
    """ws (B, num_ws, 512) W+ latents; c (B, 25) OpenCV label.

    noise_mode "const" or "none"; `render_generator` draws the depth
    jitter (None: deterministic, the inference path). With a model axis
    on `mesh` the ranks of its model group split each image's rays
    (`renderer.render_rays`), which come back whole before the feature
    image is formed; everything else runs replicated on each rank."""
    b = ws.shape[0]
    res = neural_rendering_resolution or cfg.render.neural_rendering_resolution
    cam2world, intrinsics = cam.unpack_label(c)
    ray_origins, ray_directions = cam.generate_rays(cam2world, intrinsics, res)

    planes = nets.backbone_apply(params["backbone"], cfg.backbone, ws,
                                 noise_mode=noise_mode,
                                 compute_dtype=cfg.compute_dtype)
    h, w = planes.shape[2:]
    planes = planes.reshape(b, 3, cfg.plane_channels, h, w)
    planes = planes.permute(0, 1, 3, 4, 2)               # (B, 3, H, W, C)

    feature_samples, depth_samples, _ = rnd.render_rays(
        params["decoder"], cfg.render, planes, ray_origins, ray_directions,
        generator=render_generator, ray_grid=(res, res), mesh=mesh)

    feature_image = feature_samples.permute(0, 2, 1).reshape(b, -1, res, res)
    rgb_image = feature_image[:, :3]
    sr_image = nets.superresolution_apply(
        params["superresolution"], cfg.sr, rgb_image, feature_image, ws,
        noise_mode="none", compute_dtype=cfg.compute_dtype)
    return {"image": sr_image.permute(0, 2, 3, 1),
            "image_raw": rgb_image.permute(0, 2, 3, 1),
            "image_depth": depth_samples.reshape(b, res, res, 1)}
