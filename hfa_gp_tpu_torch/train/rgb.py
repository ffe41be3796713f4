"""RGB-driven training (port of hfa_gp_tpu/train/rgb.py).

Loss = L2 + LPIPS on the 512 → size average-pooled render, gradients
by autograd through the sampler's and the marcher's CUDA kernels. On the
card, on one rank, `train_step`'s loss and its backward replay as two
CUDA graphs (`core.graphs.loss`) from a key's second step on; Adam and
the freeze gate run eagerly.
With a mesh, `train_step` averages the gradients and loss terms over
its data axis (`mesh.data_parallel_step`); with a model axis on it the
model group's ranks split the render's rays, each holding the whole loss.
"""

from __future__ import annotations

import torch

from ..core import camera as cam
from ..core import graphs, ops
from ..models import lpips as lpips_mod
from ..models.avatar import heads
from ..parallel import mesh as mesh_mod
from ..utils.observability import annotate
from .state import TrainState, apply_generator_freeze


def loss_fn(params, lpips_params, cfg: heads.AvatarConfig,
            real_image: torch.Tensor, label: torch.Tensor, *,
            label_convention: str = "opencv", mesh=None):
    """real_image (B, size, size, 3) in [-1, 1]; label (B, 25) → (loss,
    {"l2_loss", "lpips_loss", "generated"})."""
    weights = heads.rgb_get_weights(params, cfg, real_image)
    if cfg.out_pose:
        weights, _pose = weights
    latent = heads.get_latent(params, weights, cfg)
    generated = heads.get_image(params, cfg, latent, label,
                                label_convention=label_convention, mesh=mesh)
    generated = ops.avg_pool_to(generated, cfg.size)
    l2 = (real_image - generated).square().mean()
    lp = lpips_mod.lpips_distance(lpips_params, real_image, generated).mean()
    return l2 + lp, {"l2_loss": l2, "lpips_loss": lp, "generated": generated}


def _loss_terms(trees, real_image, label, cfg, label_convention, mesh=None):
    """(loss, l2, lpips) of `loss_fn` as one tensor (3,)."""
    loss, aux = loss_fn(trees["params"], trees["lpips"], cfg, real_image,
                        label, label_convention=label_convention, mesh=mesh)
    return torch.stack((loss, aux["l2_loss"], aux["lpips_loss"]))


def train_step(state: TrainState, lpips_params, cfg: heads.AvatarConfig,
               real_image: torch.Tensor, label: torch.Tensor,
               tune_iter: int, *, label_convention: str = "opencv", mesh=None
               ) -> dict[str, torch.Tensor]:
    """One Adam step in place on `state`; returns the step's loss terms as
    detached 0-d tensors of their own (no host sync here). Profiler ranges
    (`utils.observability.annotate`): "train_step" holding "forward"
    (`loss_fn`, or its graph's replay), "backward" (autograd; a replay
    of the loss's backward graph) and "optimizer" (the freeze gate, the
    join over the data axis, Adam)."""
    # a data or model axis keeps its collectives eager; one rank has none
    graphed = mesh is None or mesh.size == 1
    with annotate("train_step"):
        state.optimizer.zero_grad(set_to_none=True)
        with annotate("forward"):
            terms = graphs.loss(
                "rgb_loss", _loss_terms,
                {"params": state.params, "lpips": lpips_params}, real_image,
                label, enabled=graphed,
                static=(cfg, label_convention) if graphed
                else (cfg, label_convention, mesh))
        with annotate("backward"):
            terms[0].backward()
        with annotate("optimizer"):
            apply_generator_freeze(state.params, state.step, tune_iter)
            loss, l2, lp = terms.detach().unbind()
            metrics = mesh_mod.data_parallel_step(state.params, {
                "loss": loss, "l2_loss": l2, "lpips_loss": lp}, mesh)
            state.optimizer.step()
        state.step += 1
    return metrics


def sample(params, cfg: heads.AvatarConfig, real_image: torch.Tensor,
           label: torch.Tensor, *, label_convention: str = "opencv",
           mesh=None):
    """The trainer's eval forward (the JAX `make_eval_step`): no graph."""
    with torch.inference_mode():
        return heads.rgb_forward(params, cfg, real_image, label,
                                 label_convention=label_convention, mesh=mesh)


def sample_bases(params, cfg: heads.AvatarConfig, weight_value: float = 10.0,
                 batch: int = 8) -> torch.Tensor:
    """Every basis direction rendered with a weight spike from the mean
    camera → (dim_shape, 512, 512, 3) on the CPU, rendered `batch`
    directions at a time to bound device memory."""
    dev = params["subspace"]["bases"].device
    label = cam.sample_camera_label(None, n=1, mode=None).to(dev)
    n = cfg.dim_shape
    weights = torch.eye(n, device=dev) * weight_value
    out = []
    with torch.inference_mode():
        latents = heads.get_latent(params, weights, cfg)
        for i in range(0, n, batch):
            lat = latents[i:i + batch]
            out.append(heads.get_image(
                params, cfg, lat, label.expand(lat.shape[0], -1),
                label_convention="opengl").cpu())
    return torch.cat(out)
