"""Backbone export and FLOPs accounting (counterpart of
hfa_gp_tpu/utils/export.py, whose `export_stablehlo` and `flops` serialise
a jitted function with `jax.export` and read XLA's cost analysis).

  * `export_backbone`: an arcface backbone in eval mode → a
    `torch.export` program with a dynamic batch, saved as `model.pt2`;
    `torch.export.load(path).module()` runs it. There is no fallback to a
    fixed batch: a backbone that does not export with a dynamic one
    raises;
  * `flops`: the floating-point operations of one call, counted by
    `torch.utils.flop_counter.FlopCounterMode` (matmuls and convolutions).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..models.arcface import registry

MAX_BATCH = 4096


class Embedder(nn.Module):
    """(B, 112, 112, 3) images → (B, embedding_dim) fp32 embeddings of
    `network` in eval mode; the parameters and running moments are its
    submodules."""

    def __init__(self, network: str, params: nn.Module,
                 batch_stats: nn.Module):
        super().__init__()
        self.network = network
        self.params = params
        self.batch_stats = batch_stats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return registry.backbone_apply(self.network, self.params,
                                       self.batch_stats, x)


def export_backbone(network: str, params: nn.Module, batch_stats: nn.Module,
                    path: str) -> torch.export.ExportedProgram:
    """Export the backbone with a symbolic batch (1 … MAX_BATCH) on the
    parameters' device and save it to `path` (`model.pt2`)."""
    model = Embedder(network, params, batch_stats).eval()
    dev = next(params.parameters()).device
    example = torch.zeros((2, 112, 112, 3), device=dev)
    batch = torch.export.Dim("batch", min=1, max=MAX_BATCH)
    with torch.no_grad():
        program = torch.export.export(model, (example,),
                                      dynamic_shapes=({0: batch},))
    torch.export.save(program, path)
    return program


def flops(fn: Callable, *args) -> dict[str, float]:
    """{"flops": the operations of fn(*args)}, as FlopCounterMode counts
    them (a multiply-add is two)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*args)
    return {"flops": float(counter.get_total_flops())}
