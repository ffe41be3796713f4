"""Audio-driven training (port of hfa_gp_tpu/train/audio.py).

Two phases: before `nosmo_iters` AudioNet encodes the frame's own 16 × 29
DeepSpeech window; from it on, AudioNet encodes each of the smo_size
windows around the frame and AudioAttNet smooths their codes.

The reference steps three Adams of one learning rate (the model's, the
AudioNet's, the AudioAttNet's), and the JAX package keeps three optax
legs, each with its own bias-correction count. Here they are one
`torch.optim.Adam`: torch keeps a step count for each parameter, so the
arithmetic is the same. At the phase switch `reset_audattnet_opt` drops
the AudioAttNet's state, so its count and moments start from zero, as the
reference's optimizer that takes its first step there. Before the switch
the loss never reads the AudioAttNet: its gradients become zeros (never
skipped), so its moments and count advance as optax's do.
"""

from __future__ import annotations

import torch

from ..core import ops
from ..models import lpips as lpips_mod
from ..models.avatar import audio as aud
from ..models.avatar import heads
from ..parallel import mesh as mesh_mod
from ..utils.convert import ParamTree
from .state import TrainState, apply_generator_freeze


def init_audio_params(g: torch.Generator, cfg: heads.AvatarConfig,
                      device: torch.device | str = "cpu",
                      generator_params: dict | None = None) -> ParamTree:
    """{"model": the audio avatar, "audnet": AudioNet, "audattnet":
    AudioAttNet (scores over its default 32 channels)} from `g`."""
    return ParamTree({
        "model": heads.init_avatar_audio(g, cfg, device, generator_params),
        "audnet": aud.init_audio_net(g, cfg.dim_aud, cfg.win_size),
        "audattnet": aud.init_audio_att_net(g, seq_len=cfg.smo_size),
    }).to(device)


def encode_audio(params, cfg: heads.AvatarConfig, aud_window: torch.Tensor,
                 smooth: bool) -> torch.Tensor:
    """aud_window (B, smo_size, 16, 29) when smooth, else (B, 16, 29) →
    audio code (B, dim_aud). The attention net runs on the whole batch."""
    if not smooth:
        return aud.audio_net_apply(params["audnet"], aud_window,
                                   cfg.win_size)
    b, smo, w, c = aud_window.shape
    codes = aud.audio_net_apply(params["audnet"],
                                aud_window.reshape(b * smo, w, c),
                                cfg.win_size)
    return aud.audio_att_net_apply(params["audattnet"],
                                   codes.reshape(b, smo, -1),
                                   seq_len=cfg.smo_size)


def loss_fn(params, lpips_params, cfg: heads.AvatarConfig,
            real_image: torch.Tensor, label: torch.Tensor,
            aud_window: torch.Tensor, smooth: bool, *,
            label_convention: str = "opencv", mesh=None):
    """→ (loss, {"l2_loss", "lpips_loss", "generated"}), as the RGB loss."""
    code = encode_audio(params, cfg, aud_window, smooth)
    generated = heads.audio_forward(params["model"], cfg, code, label,
                                    label_convention=label_convention,
                                    mesh=mesh)
    generated = ops.avg_pool_to(generated, cfg.size)
    l2 = (real_image - generated).square().mean()
    lp = lpips_mod.lpips_distance(lpips_params, real_image, generated).mean()
    return l2 + lp, {"l2_loss": l2, "lpips_loss": lp, "generated": generated}


def reset_audattnet_opt(state: TrainState) -> None:
    """A fresh AudioAttNet optimizer at the nosmo → smooth switch: its
    parameters' Adam state (count and moments) is dropped, in place."""
    for p in state.params["audattnet"].parameters():
        state.optimizer.state.pop(p, None)


def train_step(state: TrainState, lpips_params, cfg: heads.AvatarConfig,
               real_image: torch.Tensor, label: torch.Tensor,
               aud_window: torch.Tensor, smooth: bool, tune_iter: int, *,
               label_convention: str = "opencv",
               mesh=None) -> dict[str, torch.Tensor]:
    """One Adam step of the phase `smooth` in place on `state`; the freeze
    gate applies to the model's generator. Returns the loss terms as
    detached 0-d tensors."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, aux = loss_fn(state.params, lpips_params, cfg, real_image, label,
                        aud_window, smooth,
                        label_convention=label_convention, mesh=mesh)
    loss.backward()
    for p in state.params.parameters():      # the unread AudioAttNet
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    apply_generator_freeze(state.params["model"], state.step, tune_iter)
    metrics = mesh_mod.data_parallel_step(state.params, {
        "loss": loss.detach(), "l2_loss": aux["l2_loss"].detach(),
        "lpips_loss": aux["lpips_loss"].detach()}, mesh)
    state.optimizer.step()
    state.step += 1
    return {"l2_loss_3dmm": torch.zeros(()), **metrics}


def sample(params, cfg: heads.AvatarConfig, aud_window: torch.Tensor,
           label: torch.Tensor, smooth: bool, *,
           label_convention: str = "opencv", mesh=None):
    """The reenactment forward: audio window(s) → image, no graph."""
    with torch.inference_mode():
        code = encode_audio(params, cfg, aud_window, smooth)
        return heads.audio_forward(params["model"], cfg, code, label,
                                   label_convention=label_convention,
                                   mesh=mesh)
