"""Avatar heads in PyTorch (port of hfa_gp_tpu/models/avatar/heads.py):
  * RGB-driven:   image → encoder → α → QR subspace → EG3D → 512² image;
  * 3DMM-driven:  expression coefficients → MLP → α → subspace → EG3D;
  * audio-driven: audio code (AudioNet [+ AudioAttNet], which live in the
    trainer) → MLP → α → subspace → EG3D.

Labels: dataset labels are OpenCV and pass through; sampled cameras are
OpenGL and are flipped once (`label_convention="opengl"`).

`mesh` (a `parallel.mesh.Mesh`, optional) reaches the EG3D synthesis:
with a model axis its ranks split each image's rays.

Params: one `ParamTree` with the JAX keys
    {"encoder" | "weights_mlp": ..., "subspace": {bases, delta},
     "generator": <EG3D>}
and, for an RGB model with `person_2`, "subspace_2": {bases, delta} (no
bases under `same_bases`: person 2 shares person 1's).
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
    params_len: int = 76            # 3DMM expression-vector length
    dim_aud: int = 64               # audio code width
    win_size: int = 16              # DeepSpeech frames a window
    smo_size: int = 8               # windows a smoothing window
    person_2: bool = False          # a second person's subspace (RGB)
    same_bases: bool = False        # person 2 shares the bases, own delta
    eg3d: EG3DConfig = field(default_factory=EG3DConfig)


def init_avatar_rgb(g: torch.Generator, cfg: AvatarConfig,
                    device: torch.device | str = "cpu",
                    generator_params: dict | None = None,
                    init_bases_2=None) -> ParamTree:
    """Random avatar params from `g`, on `device`. Draw from a CPU
    generator: the same seed then gives the same params on every device.
    `generator_params` (a nested dict of tensors in the port's layout)
    takes the place of the random EG3D generator. With `cfg.person_2`,
    "subspace_2" is drawn last (the other params do not change) or taken
    from `init_bases_2` (`subspace.load_pti_bases`)."""
    tree = {
        "encoder": enc.init_encoder(g, cfg.size, cfg.dim, cfg.dim_shape,
                                    cfg.out_pose),
        "subspace": sub.init_subspace(g, cfg.dim_shape, cfg.eg3d.num_ws,
                                      cfg.dim),
        "generator": generator_params if generator_params is not None
        else eg3d_gen.init_generator(g, cfg.eg3d),
    }
    if cfg.person_2:
        sub2 = sub.init_subspace(g, cfg.dim_shape, cfg.eg3d.num_ws, cfg.dim,
                                 init_bases_2)
        if cfg.same_bases:
            del sub2["bases"]
        tree["subspace_2"] = sub2
    return ParamTree(tree).to(device)


def _init_weights_mlp(g: torch.Generator, in_dim: int,
                      cfg: AvatarConfig) -> dict:
    """Weights_3DMM: 7 EqualLinear layers, in → dim × 6 → dim_shape."""
    return enc.init_linear_stack(g, [in_dim] + [cfg.dim] * 6
                                 + [cfg.dim_shape])


def _init_mlp_avatar(g: torch.Generator, in_dim: int, cfg: AvatarConfig,
                     device, generator_params: dict | None) -> ParamTree:
    tree = {
        "weights_mlp": _init_weights_mlp(g, in_dim, cfg),
        "subspace": sub.init_subspace(g, cfg.dim_shape, cfg.eg3d.num_ws,
                                      cfg.dim),
        "generator": generator_params if generator_params is not None
        else eg3d_gen.init_generator(g, cfg.eg3d),
    }
    return ParamTree(tree).to(device)


def init_avatar_3dmm(g: torch.Generator, cfg: AvatarConfig,
                     device: torch.device | str = "cpu",
                     generator_params: dict | None = None) -> ParamTree:
    """The 3DMM model: Weights_3DMM on params_len coefficients."""
    return _init_mlp_avatar(g, cfg.params_len, cfg, device,
                            generator_params)


def init_avatar_audio(g: torch.Generator, cfg: AvatarConfig,
                      device: torch.device | str = "cpu",
                      generator_params: dict | None = None) -> ParamTree:
    """The audio model: Weights_3DMM on dim_aud codes (AudioNet and
    AudioAttNet live in the trainer, `train/audio.py`)."""
    return _init_mlp_avatar(g, cfg.dim_aud, cfg, device, generator_params)


def get_latent(params, weights: torch.Tensor, cfg: AvatarConfig,
               person_2: bool = False) -> torch.Tensor:
    """person_2 selects the second subspace: its delta, and its bases
    unless it has none (same_bases)."""
    if not person_2:
        return sub.get_latent(params["subspace"], weights, cfg.dim)
    sp2 = params["subspace_2"]
    return sub.get_latent({"bases": sp2.get("bases",
                                            params["subspace"]["bases"]),
                           "delta": sp2["delta"]}, weights, cfg.dim)


def _normalize_label(label: torch.Tensor,
                     label_convention: str) -> torch.Tensor:
    if label_convention == "opencv":
        return label
    if label_convention == "opengl":
        return cam.flip_yz_label(label)
    raise ValueError(label_convention)


def get_image(params, cfg: AvatarConfig, latent: torch.Tensor,
              label: torch.Tensor, *, label_convention: str = "opencv",
              noise_mode: str = "const", mesh=None) -> torch.Tensor:
    """(B, num_ws, 512) W+ → (B, 512, 512, 3) image in [-1, 1]."""
    c = _normalize_label(label, label_convention)
    return eg3d_gen.synthesis(params["generator"], cfg.eg3d, latent, c,
                              noise_mode=noise_mode, mesh=mesh)["image"]


def rgb_get_weights(params, cfg: AvatarConfig, image: torch.Tensor):
    return enc.encoder_apply(params["encoder"], image,
                             use_softmax=cfg.use_softmax)


def rgb_forward(params, cfg: AvatarConfig, image: torch.Tensor,
                label: torch.Tensor, *, person_2: bool = False,
                label_convention: str = "opencv", mesh=None):
    """image (B, size, size, 3) in [-1, 1], label (B, 25) → image
    (B, 512, 512, 3) [, pose (B, 25) when cfg.out_pose]; person_2 renders
    through the second subspace."""
    weights = rgb_get_weights(params, cfg, image)
    pose = None
    if cfg.out_pose:
        weights, pose = weights
    img = get_image(params, cfg, get_latent(params, weights, cfg, person_2),
                    label, label_convention=label_convention, mesh=mesh)
    return (img, pose) if cfg.out_pose else img


def mlp_get_weights(params, cfg: AvatarConfig,
                    driving: torch.Tensor) -> torch.Tensor:
    """(B, params_len | dim_aud) → driving weights (B, dim_shape)."""
    w = enc.linear_stack_apply(params["weights_mlp"], driving)
    return torch.softmax(w, dim=1) if cfg.use_softmax else w


def t3dmm_forward(params, cfg: AvatarConfig, coeffs: torch.Tensor,
                  label: torch.Tensor, *, label_convention: str = "opencv",
                  mesh=None):
    """coeffs (B, params_len), label (B, 25) → image (B, 512, 512, 3)."""
    latent = get_latent(params, mlp_get_weights(params, cfg, coeffs), cfg)
    return get_image(params, cfg, latent, label,
                     label_convention=label_convention, mesh=mesh)


def audio_forward(params, cfg: AvatarConfig, aud_code: torch.Tensor,
                  label: torch.Tensor, *, label_convention: str = "opencv",
                  mesh=None):
    """aud_code (B, dim_aud), the AudioNet/AudioAttNet output; label
    (B, 25) → image (B, 512, 512, 3)."""
    latent = get_latent(params, mlp_get_weights(params, cfg, aud_code), cfg)
    return get_image(params, cfg, latent, label,
                     label_convention=label_convention, mesh=mesh)
