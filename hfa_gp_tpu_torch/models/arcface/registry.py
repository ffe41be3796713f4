"""Backbone registry (port of hfa_gp_tpu/models/arcface/registry.py): one
contract for every backbone,

  init_backbone(generator, name, embedding_dim, device)
      -> (params, batch_stats)
  backbone_apply(name, params, batch_stats, x, train=...)
      -> embeddings                      (train=False)
      -> (embeddings, new_batch_stats)   (train=True)

The reference's short names (r18 … r2060) and the long ones (iresnet50)
both resolve. Of the JAX package's backbones the iresnets are ported; the
MobileFaceNet (`mbf*`) and ViT (`vit_*`) names are known and raise.
"""

from __future__ import annotations

import torch

from . import iresnet

_ALIASES = {
    "r18": "iresnet18", "r34": "iresnet34", "r50": "iresnet50",
    "r100": "iresnet100", "r200": "iresnet200", "r2060": "iresnet2060",
    "mobilefacenet": "mbf",
}
def canonical_name(name: str) -> str:
    return _ALIASES.get(name, name)


def backbone_names() -> list[str]:
    return sorted(iresnet.IRESNET_LAYERS)


def _resolve(name: str) -> str:
    name = canonical_name(name)
    if name in iresnet.IRESNET_LAYERS:
        return name
    if name.startswith(("mbf", "vit_")):
        raise NotImplementedError(
            f"backbone {name!r}: MobileFaceNet and ViT are not ported yet "
            "(the arcface slice after the iresnets); available: "
            f"{backbone_names()}")
    raise ValueError(
        f"unknown backbone {name!r}; available: {backbone_names()}")


def init_backbone(generator: torch.Generator, name: str,
                  embedding_dim: int = 512,
                  device: torch.device | str = "cpu"):
    return iresnet.init_iresnet(generator, _resolve(name), embedding_dim,
                                device=device)


def backbone_apply(name: str, params, batch_stats, x: torch.Tensor, *,
                   train: bool = False):
    return iresnet.iresnet_apply(params, batch_stats, x, _resolve(name),
                                 train=train)
