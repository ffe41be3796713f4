"""RGB-driven avatar head in PyTorch (port of the RGB subset of
hfa_gp_tpu/models/avatar/heads.py): image → encoder → α → QR subspace →
EG3D synthesis → 512² image.

Labels: dataset labels are OpenCV and pass through; sampled cameras are
OpenGL and are flipped once (`label_convention="opengl"`).

Params: one `ParamTree` with the JAX keys
    {"encoder": ..., "subspace": {bases, delta}, "generator": <EG3D>}
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ...core import camera as cam
from ...utils.convert import ParamTree
from ..eg3d import generator as eg3d_gen
from ..eg3d.generator import EG3DConfig
from . import encoder as enc
from . import subspace as sub


@dataclass(frozen=True)
class AvatarConfig:
    size: int = 256                 # encoder input resolution
    dim: int = 512                  # latent_dim_style
    dim_shape: int = 50             # latent_dim_shape
    use_softmax: bool = False
    out_pose: bool = False
    eg3d: EG3DConfig = field(default_factory=EG3DConfig)


def init_avatar_rgb(g: torch.Generator, cfg: AvatarConfig,
                    device: torch.device | str = "cpu") -> ParamTree:
    """Random avatar params from `g`, on `device`. Draw from a CPU
    generator: the same seed then gives the same params on every device."""
    tree = {
        "encoder": enc.init_encoder(g, cfg.size, cfg.dim, cfg.dim_shape,
                                    cfg.out_pose),
        "subspace": sub.init_subspace(g, cfg.dim_shape, cfg.eg3d.num_ws,
                                      cfg.dim),
        "generator": eg3d_gen.init_generator(g, cfg.eg3d),
    }
    return ParamTree(tree).to(device)


def get_latent(params, weights: torch.Tensor,
               cfg: AvatarConfig) -> torch.Tensor:
    return sub.get_latent(params["subspace"], weights, cfg.dim)


def _normalize_label(label: torch.Tensor,
                     label_convention: str) -> torch.Tensor:
    if label_convention == "opencv":
        return label
    if label_convention == "opengl":
        return cam.flip_yz_label(label)
    raise ValueError(label_convention)


def get_image(params, cfg: AvatarConfig, latent: torch.Tensor,
              label: torch.Tensor, *, label_convention: str = "opencv",
              noise_mode: str = "const") -> torch.Tensor:
    """(B, num_ws, 512) W+ → (B, 512, 512, 3) image in [-1, 1]."""
    c = _normalize_label(label, label_convention)
    return eg3d_gen.synthesis(params["generator"], cfg.eg3d, latent, c,
                              noise_mode=noise_mode)["image"]


def rgb_get_weights(params, cfg: AvatarConfig, image: torch.Tensor):
    return enc.encoder_apply(params["encoder"], image,
                             use_softmax=cfg.use_softmax)


def rgb_forward(params, cfg: AvatarConfig, image: torch.Tensor,
                label: torch.Tensor, *, label_convention: str = "opencv"):
    """image (B, size, size, 3) in [-1, 1], label (B, 25) → image
    (B, 512, 512, 3) [, pose (B, 25) when cfg.out_pose]."""
    weights = rgb_get_weights(params, cfg, image)
    pose = None
    if cfg.out_pose:
        weights, pose = weights
    img = get_image(params, cfg, get_latent(params, weights, cfg), label,
                    label_convention=label_convention)
    return (img, pose) if cfg.out_pose else img
