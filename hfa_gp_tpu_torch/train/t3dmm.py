"""3DMM-coefficient-driven training (port of hfa_gp_tpu/train/t3dmm.py).

The RGB trainer's loss (L2 + LPIPS on the 512 → size average-pooled
render) with the expression coefficients in place of the encoder. The
metrics keep the reference's zero `l2_loss_3dmm` slot.
"""

from __future__ import annotations

import torch

from ..core import ops
from ..models import lpips as lpips_mod
from ..models.avatar import heads
from ..parallel import mesh as mesh_mod
from .state import TrainState, apply_generator_freeze


def loss_fn(params, lpips_params, cfg: heads.AvatarConfig,
            real_image: torch.Tensor, label: torch.Tensor,
            coeffs: torch.Tensor, *, label_convention: str = "opencv",
            mesh=None):
    """real_image (B, size, size, 3) in [-1, 1], label (B, 25), coeffs
    (B, params_len) → (loss, {"l2_loss", "lpips_loss", "generated"})."""
    generated = heads.t3dmm_forward(params, cfg, coeffs, label,
                                    label_convention=label_convention,
                                    mesh=mesh)
    generated = ops.avg_pool_to(generated, cfg.size)
    l2 = (real_image - generated).square().mean()
    lp = lpips_mod.lpips_distance(lpips_params, real_image, generated).mean()
    return l2 + lp, {"l2_loss": l2, "lpips_loss": lp, "generated": generated}


def train_step(state: TrainState, lpips_params, cfg: heads.AvatarConfig,
               real_image: torch.Tensor, label: torch.Tensor,
               coeffs: torch.Tensor, tune_iter: int, *,
               label_convention: str = "opencv",
               mesh=None) -> dict[str, torch.Tensor]:
    """One Adam step in place on `state`, the generator frozen while
    step < tune_iter; returns the step's loss terms as detached 0-d
    tensors."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, aux = loss_fn(state.params, lpips_params, cfg, real_image, label,
                        coeffs, label_convention=label_convention, mesh=mesh)
    loss.backward()
    apply_generator_freeze(state.params, state.step, tune_iter)
    metrics = mesh_mod.data_parallel_step(state.params, {
        "loss": loss.detach(), "l2_loss": aux["l2_loss"].detach(),
        "lpips_loss": aux["lpips_loss"].detach()}, mesh)
    state.optimizer.step()
    state.step += 1
    return {"l2_loss_3dmm": torch.zeros(()), **metrics}


def sample(params, cfg: heads.AvatarConfig, coeffs: torch.Tensor,
           label: torch.Tensor, *, label_convention: str = "opencv",
           mesh=None):
    """The trainer's eval forward: no graph."""
    with torch.inference_mode():
        return heads.t3dmm_forward(params, cfg, coeffs, label,
                                   label_convention=label_convention,
                                   mesh=mesh)
