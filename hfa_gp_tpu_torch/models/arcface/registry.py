"""Backbone registry (port of hfa_gp_tpu/models/arcface/registry.py): one
contract for every backbone,

  init_backbone(generator, name, embedding_dim, device)
      -> (params, batch_stats)
  backbone_apply(name, params, batch_stats, x, train=..., dtype=...,
                 generator=...)
      -> embeddings                      (train=False)
      -> (embeddings, new_batch_stats)   (train=True)

The reference's short names (r18 … r2060, mobilefacenet) and the long ones
(iresnet50) both resolve. `dtype` is the trunk's (fp32 or bf16); the
embeddings come out in fp32. `generator` feeds the ViTs' drop path and
masking in training (a generator on the input's device; seed 0 when none
is given, as the JAX package falls back to PRNGKey(0)); the other
backbones draw nothing.
"""

from __future__ import annotations

import torch

from . import iresnet, mobilefacenet, vit

_ALIASES = {
    "r18": "iresnet18", "r34": "iresnet34", "r50": "iresnet50",
    "r100": "iresnet100", "r200": "iresnet200", "r2060": "iresnet2060",
    "mobilefacenet": "mbf",
}


def canonical_name(name: str) -> str:
    return _ALIASES.get(name, name)


def backbone_names() -> list[str]:
    return (sorted(iresnet.IRESNET_LAYERS)
            + sorted(mobilefacenet.MBF_CONFIGS) + sorted(vit.VIT_CONFIGS))


def _unknown(name: str) -> ValueError:
    return ValueError(
        f"unknown backbone {name!r}; available: {backbone_names()}")


def init_backbone(generator: torch.Generator, name: str,
                  embedding_dim: int = 512,
                  device: torch.device | str = "cpu"):
    name = canonical_name(name)
    if name in iresnet.IRESNET_LAYERS:
        return iresnet.init_iresnet(generator, name, embedding_dim,
                                    device=device)
    if name in mobilefacenet.MBF_CONFIGS:
        return mobilefacenet.init_mobilefacenet(generator, embedding_dim,
                                                name, device)
    if name in vit.VIT_CONFIGS:
        return vit.init_vit(generator, name, embedding_dim, device)
    raise _unknown(name)


def backbone_apply(name: str, params, batch_stats, x: torch.Tensor, *,
                   train: bool = False, dtype: torch.dtype = torch.float32,
                   generator: torch.Generator | None = None):
    name = canonical_name(name)
    if name in iresnet.IRESNET_LAYERS:
        return iresnet.iresnet_apply(params, batch_stats, x, name,
                                     train=train, dtype=dtype)
    if name in mobilefacenet.MBF_CONFIGS:
        return mobilefacenet.mobilefacenet_apply(params, batch_stats, x,
                                                 name=name, train=train,
                                                 dtype=dtype)
    if name in vit.VIT_CONFIGS:
        if train and generator is None:
            generator = torch.Generator(x.device).manual_seed(0)
        return vit.vit_apply(params, x, name, dtype,
                             batch_stats=batch_stats, train=train,
                             generator=generator)
    raise _unknown(name)
