"""Training state and the generator freeze schedule (port of
hfa_gp_tpu/train/state.py).

The JAX package multiplies the generator's gradients by [step >= tune_iter]
inside its step, so optax's Adam sees zero gradients through the frozen
phase: its step count and moments advance, and the first unfrozen update
is bias-corrected as a late step. The port keeps exactly that: generator
gradients are multiplied by the gate, never skipped, and a parameter the
loss does not reach gets a zero gradient, so `torch.optim.Adam` keeps one
step count and one pair of moments for every parameter, as optax does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


@dataclass
class TrainState:
    params: nn.Module               # a `utils.convert.ParamTree`
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(params: nn.Module, lr: float = 3e-4
                   ) -> torch.optim.Optimizer:
    """Adam(lr, betas=(0.9, 0.999), eps=1e-8), optax.adam's arithmetic."""
    return torch.optim.Adam(params.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def init_state(params: nn.Module, lr: float = 3e-4) -> TrainState:
    """`ParamTree` leaves are created frozen; training turns them on."""
    params.requires_grad_(True)
    return TrainState(params=params, optimizer=make_optimizer(params, lr))


def apply_generator_freeze(params: nn.Module, step: int,
                           tune_iter: int) -> None:
    """In place, after backward: every missing gradient becomes zeros, and
    the EG3D generator's gradients are zeroed while step < tune_iter."""
    for p in params.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if step < tune_iter:
        for p in params["generator"].parameters():
            p.grad.mul_(0.0)
