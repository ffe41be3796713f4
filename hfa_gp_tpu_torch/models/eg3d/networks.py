"""StyleGAN2 networks of the EG3D generator in PyTorch (port of
hfa_gp_tpu/models/eg3d/networks.py): mapping network, tri-plane backbone
and the super-resolution head.

`init_*` build nested dicts of tensors (OIHW conv weights) from an explicit
`torch.Generator`; `*_apply` are plain functions on tensors that read a
param tree by the JAX keys (a dict or a `utils.convert.ParamTree`).
Feature maps are NCHW inside. `compute_dtype` (bf16 under `--bf16`; None,
the default, keeps the dtype of the params) is the dtype of the synthesis
chain `x`; each torgb output is cast back to the dtype of the latents
(fp32), so the image / plane chain stays fp32, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ...core import ops


@dataclass(frozen=True)
class BackboneConfig:
    """StyleGAN2 backbone producing the 96-channel tri-plane stack."""
    w_dim: int = 512
    img_resolution: int = 256          # tri-plane spatial resolution
    img_channels: int = 96             # 3 planes x 32 features
    channel_base: int = 32768
    channel_max: int = 512
    conv_clamp: float | None = 256.0
    fir: tuple[int, ...] = (1, 3, 3, 1)

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def block_resolutions(self) -> tuple[int, ...]:
        n = int(math.log2(self.img_resolution))
        return tuple(2 ** i for i in range(2, n + 1))

    @property
    def num_ws(self) -> int:
        return 1 + 2 * (len(self.block_resolutions) - 1) + 1


@dataclass(frozen=True)
class MappingConfig:
    z_dim: int = 512
    c_dim: int = 25
    w_dim: int = 512
    num_layers: int = 2
    lr_multiplier: float = 0.01


@dataclass(frozen=True)
class SRConfig:
    """SuperresolutionHybrid8XDC: 128² neural render → 512² RGB; inputs
    below 128² are bilinearly resized up first (antialiased)."""
    input_resolution: int = 128
    output_resolution: int = 512
    in_channels: int = 32
    block_channels: tuple[int, int] = (256, 128)
    w_dim: int = 512
    conv_clamp: float | None = 256.0
    antialias: bool = True
    fir: tuple[int, ...] = (1, 3, 3, 1)


# -- init ---------------------------------------------------------------------


def _randn(g: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=g, dtype=torch.float32)


def _init_fc(g, in_dim, out_dim, bias_init=0.0) -> dict:
    return {"weight": _randn(g, out_dim, in_dim),
            "bias": torch.full((out_dim,), float(bias_init))}


def _init_synth_layer(g, in_ch, out_ch, w_dim, resolution, kernel=3) -> dict:
    return {"weight": _randn(g, out_ch, in_ch, kernel, kernel),
            "bias": torch.zeros(out_ch),
            "affine": _init_fc(g, w_dim, in_ch, bias_init=1.0),
            "noise_strength": torch.zeros(()),
            "noise_const": torch.zeros(resolution, resolution)}


def _init_torgb(g, in_ch, out_ch, w_dim) -> dict:
    return {"weight": _randn(g, out_ch, in_ch, 1, 1),
            "bias": torch.zeros(out_ch),
            "affine": _init_fc(g, w_dim, in_ch, bias_init=1.0)}


def init_mapping(g: torch.Generator, cfg: MappingConfig) -> dict:
    p = {"w_avg": torch.zeros(cfg.w_dim)}
    if cfg.c_dim > 0:
        p["embed"] = _init_fc(g, cfg.c_dim, cfg.w_dim)
    in_dim = cfg.z_dim + (cfg.w_dim if cfg.c_dim > 0 else 0)
    for i in range(cfg.num_layers):
        p[f"fc{i}"] = _init_fc(g, in_dim, cfg.w_dim)
        in_dim = cfg.w_dim
    return p


def init_block(g, in_ch, out_ch, w_dim, resolution, img_channels, *,
               is_first: bool) -> dict:
    p = {}
    if is_first:
        p["const"] = _randn(g, out_ch, resolution, resolution)
    else:
        p["conv0"] = _init_synth_layer(g, in_ch, out_ch, w_dim, resolution)
    p["conv1"] = _init_synth_layer(g, out_ch, out_ch, w_dim, resolution)
    p["torgb"] = _init_torgb(g, out_ch, img_channels, w_dim)
    return p


def init_backbone(g: torch.Generator, cfg: BackboneConfig) -> dict:
    p, in_ch = {}, 0
    for res in cfg.block_resolutions:
        out_ch = cfg.channels(res)
        p[f"b{res}"] = init_block(g, in_ch, out_ch, cfg.w_dim, res,
                                  cfg.img_channels, is_first=(res == 4))
        in_ch = out_ch
    return p


def init_superresolution(g: torch.Generator, cfg: SRConfig) -> dict:
    c0, c1 = cfg.block_channels
    return {
        "block0": init_block(g, cfg.in_channels, c0, cfg.w_dim,
                             cfg.output_resolution // 2, 3, is_first=False),
        "block1": init_block(g, c0, c1, cfg.w_dim, cfg.output_resolution, 3,
                             is_first=False),
    }


# -- mapping ------------------------------------------------------------------


def mapping_apply(params, cfg: MappingConfig, num_ws: int, z: torch.Tensor,
                  c: torch.Tensor | None,
                  truncation_psi: float = 1.0, *,
                  update_emas: bool = False,
                  w_avg_beta: float = 0.995) -> torch.Tensor:
    """z (B, z_dim), c (B, 25) → ws (B, num_ws, w_dim). With `update_emas`
    (GAN training) the running mean of w is tracked in place first:
    w_avg ← lerp(mean over the batch of w, w_avg, w_avg_beta)."""
    x = ops.normalize_2nd_moment(z)
    if cfg.c_dim > 0:
        if c is None:
            raise ValueError("mapping_apply: c_dim > 0 needs a label")
        e = params["embed"]
        y = ops.normalize_2nd_moment(ops.fully_connected(c, e["weight"],
                                                         e["bias"]))
        x = torch.cat([x, y], dim=-1)
    for i in range(cfg.num_layers):
        fc = params[f"fc{i}"]
        x = ops.fully_connected(x, fc["weight"], fc["bias"],
                                activation="lrelu",
                                lr_multiplier=cfg.lr_multiplier)
    if update_emas:
        with torch.no_grad():
            w_avg = params["w_avg"]
            w_avg.copy_(x.detach().mean(dim=0).lerp(w_avg, w_avg_beta))
    if truncation_psi != 1.0:
        x = params["w_avg"] + truncation_psi * (x - params["w_avg"])
    return x[:, None, :].expand(-1, num_ws, -1)


# -- synthesis layers / blocks ---------------------------------------------------


def _styles(p, w: torch.Tensor) -> torch.Tensor:
    return ops.fully_connected(w, p["affine"]["weight"], p["affine"]["bias"])


def synth_layer_apply(p, x: torch.Tensor, w: torch.Tensor, *, up: int = 1,
                      fir, conv_clamp, noise_mode: str = "const",
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
    """StyleGAN2 SynthesisLayer: modconv(+up) → noise → bias+lrelu+clamp.

    noise_mode "const" adds the layer's stored noise, "none" skips it,
    "random" (training) adds (B, 1, r, r) standard normal draws from
    `generator`, on its device, times the layer's strength."""
    weight = p["weight"]
    y = ops.modulated_conv2d(x, weight, _styles(p, w), up=up,
                             padding=weight.shape[-1] // 2,
                             resample_filter=fir)
    if noise_mode not in ("const", "none", "random"):
        raise ValueError(f"noise_mode {noise_mode!r}")
    if "noise_strength" in p and noise_mode == "const":
        y = y + (p["noise_const"] * p["noise_strength"]).to(y.dtype)[None,
                                                                       None]
    elif "noise_strength" in p and noise_mode == "random":
        if generator is None:
            raise ValueError("noise_mode 'random' draws from a generator")
        b, _, h, w_ = y.shape
        noise = torch.randn((b, 1, h, w_), generator=generator,
                            device=generator.device).to(y.device)
        y = y + (noise * p["noise_strength"]).to(y.dtype)
    return ops.bias_act(y, p["bias"], act="lrelu", clamp=conv_clamp)


def torgb_apply(p, x: torch.Tensor, w: torch.Tensor, *,
                conv_clamp) -> torch.Tensor:
    """ToRGBLayer: non-demodulated 1x1 modconv, weight gain on the styles."""
    styles = _styles(p, w) * (1.0 / math.sqrt(p["weight"].shape[1]))
    y = ops.modulated_conv2d(x, p["weight"], styles, demodulate=False)
    return ops.bias_act(y, p["bias"], clamp=conv_clamp)


def block_apply(p, x: torch.Tensor | None, img: torch.Tensor | None,
                ws_block: torch.Tensor, *, fir, conv_clamp, up: bool,
                noise_mode: str = "const",
                compute_dtype: torch.dtype | None = None,
                generator: torch.Generator | None = None):
    """One skip-architecture SynthesisBlock; ws_block (B, 3, w_dim) holds
    the conv0 (if present), conv1 and torgb slots. NCHW in and out; x
    runs in `compute_dtype` (None: as it comes), img in ws_block's dtype.
    `generator` draws the noise of `noise_mode` "random", conv0's first."""
    w_i = 0
    x = p["const"][None].expand(ws_block.shape[0], -1, -1, -1) \
        if "const" in p else x
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    if "conv0" in p:
        x = synth_layer_apply(p["conv0"], x, ws_block[:, w_i],
                              up=2 if up else 1, fir=fir,
                              conv_clamp=conv_clamp, noise_mode=noise_mode,
                              generator=generator)
        w_i += 1
    x = synth_layer_apply(p["conv1"], x, ws_block[:, w_i], fir=fir,
                          conv_clamp=conv_clamp, noise_mode=noise_mode,
                          generator=generator)
    w_i += 1
    y = torgb_apply(p["torgb"], x, ws_block[:, w_i],
                    conv_clamp=conv_clamp).to(ws_block.dtype)
    if img is not None:
        if up:
            img = ops.upsample2d(img, ops.make_fir_kernel(fir))
        img = img + y
    else:
        img = y
    return x, img


def backbone_apply(params, cfg: BackboneConfig, ws: torch.Tensor, *,
                   noise_mode: str = "const",
                   compute_dtype: torch.dtype | None = None,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """ws (B, num_ws, w_dim) → tri-plane stack (B, 96, 256, 256) NCHW, in
    ws's dtype whatever `compute_dtype` the synthesis chain runs in.
    Under noise_mode "random" each layer draws its noise from `generator`,
    in the order the layers run.

    Each block consumes `num_conv` new w's and its torgb reads the next
    block's first w; the last torgb has a slot of its own."""
    if ws.shape[1] != cfg.num_ws:
        raise ValueError(f"backbone_apply: ws {tuple(ws.shape)}, "
                         f"num_ws {cfg.num_ws}")
    x, img, w_idx = None, None, 0
    for res in cfg.block_resolutions:
        is_first = res == 4
        num_conv = 1 if is_first else 2
        ws_block = ws[:, w_idx:w_idx + num_conv + 1]
        if is_first:
            # dummy slot so (conv0, conv1, torgb) indexing sees (conv1,
            # torgb) at positions 0, 1
            ws_block = torch.cat([ws_block, torch.zeros_like(ws_block[:, :1])],
                                 dim=1)
        x, img = block_apply(params[f"b{res}"], x, img, ws_block,
                             fir=cfg.fir, conv_clamp=cfg.conv_clamp,
                             up=not is_first, noise_mode=noise_mode,
                             compute_dtype=compute_dtype, generator=generator)
        w_idx += num_conv
    return img


def bilinear_resize(x: torch.Tensor, size: int, antialias: bool
                    ) -> torch.Tensor:
    """NCHW x → (size, size), bilinear with half-pixel centres (the JAX
    package's `jax.image.resize(..., "bilinear", antialias)`)."""
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=antialias)


def superresolution_apply(params, cfg: SRConfig, rgb: torch.Tensor,
                          x: torch.Tensor, ws: torch.Tensor, *,
                          noise_mode: str = "none",
                          compute_dtype: torch.dtype | None = None
                          ) -> torch.Tensor:
    """rgb (B, 3, h, w), features (B, 32, h, w), ws (B, num_ws, w_dim) →
    (B, 3, 512, 512) in ws's dtype, all NCHW; conditioned on the last w,
    repeated 3x. Inputs below `cfg.input_resolution` are resized up to it
    first."""
    if x.shape[2] < cfg.input_resolution:
        x = bilinear_resize(x, cfg.input_resolution, cfg.antialias)
        rgb = bilinear_resize(rgb, cfg.input_resolution, cfg.antialias)
    w_last = ws[:, -1:].expand(-1, 3, -1)
    for name in ("block0", "block1"):
        x, rgb = block_apply(params[name], x, rgb, w_last, fir=cfg.fir,
                             conv_clamp=cfg.conv_clamp, up=True,
                             noise_mode=noise_mode,
                             compute_dtype=compute_dtype)
    return rgb
