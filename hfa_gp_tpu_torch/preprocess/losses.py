"""Face-reconstruction training losses (port of
hfa_gp_tpu/preprocess/losses.py).

Rebuilds reference eg3d-pose-detection/models/losses.py:13-113 (used by
Deep3DFaceRecon training; the inference pipeline only runs the regressor):

  * perceptual: 1 − cosine similarity of frozen arcface embeddings
  * photometric: masked L2 over rendered-vs-real pixels
  * landmark: weighted L2 over 68 points (eyes/nose/mouth ×20)
  * coefficient regularization: weighted L2 on id/exp/tex
  * reflectance: texture variance within the skin mask
  * gamma: SH coefficients pulled toward the channel mean
"""

from __future__ import annotations

import numpy as np
import torch


def perceptual_loss(id_featureA: torch.Tensor,
                    id_featureB: torch.Tensor) -> torch.Tensor:
    """1 − <a, b> of unit-normalized embeddings (losses.py:13-19)."""
    return (1.0 - (id_featureA * id_featureB).sum(dim=-1)).mean()


def perceptual_loss_from_images(recog_fn, image_a: torch.Tensor,
                                image_b: torch.Tensor, m: torch.Tensor,
                                dsize: int = 112) -> torch.Tensor:
    """Full PerceptualLoss.forward (losses.py:12-34): the affine crop to the
    ArcFace 112² frame, then 1 − cosine of the frozen embedder's features
    (see warp.py)."""
    from .warp import perceptual_id_loss
    return perceptual_id_loss(recog_fn, image_a, image_b, m, dsize)


def photo_loss(imageA: torch.Tensor, imageB: torch.Tensor,
               mask: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Masked per-pixel L2 norm (losses.py:40-52). Images NHWC."""
    diff = torch.sqrt(eps + ((imageA - imageB) ** 2).sum(dim=-1,
                                                          keepdim=True))
    return (diff * mask).sum() / mask.sum().clamp_min(1.0)


# eyes/nose/mouth landmarks get 20x weight (losses.py:54-68)
_LM_WEIGHTS = np.ones(68, dtype=np.float32)
_LM_WEIGHTS[28:31] = 20.0
_LM_WEIGHTS[48:68] = 20.0


def landmark_loss(predict_lm: torch.Tensor, gt_lm: torch.Tensor,
                  weight: torch.Tensor | None = None) -> torch.Tensor:
    """(B, 68, 2) weighted L2 (losses.py:54-68)."""
    w = torch.as_tensor(_LM_WEIGHTS, device=predict_lm.device) \
        if weight is None else weight
    loss = ((predict_lm - gt_lm) ** 2).sum(dim=-1) * w
    return loss.mean(dim=1).sum() / predict_lm.shape[0]


def reg_loss(coeffs: dict[str, torch.Tensor], w_id: float = 1.0,
             w_exp: float = 1.0, w_tex: float = 1.0) -> torch.Tensor:
    """Coefficient magnitude regularizer (losses.py:70-84)."""
    creg = w_id * (coeffs["id"] ** 2).sum() \
        + w_exp * (coeffs["exp"] ** 2).sum() \
        + w_tex * (coeffs["tex"] ** 2).sum()
    return creg / coeffs["id"].shape[0]


def gamma_loss(gamma: torch.Tensor) -> torch.Tensor:
    """SH coeffs pulled toward the cross-channel mean (losses.py:76-84)."""
    g = gamma.reshape(-1, 3, 9)
    return ((g - g.mean(dim=1, keepdim=True)) ** 2).mean()


def reflectance_loss(texture: torch.Tensor,
                     skin_mask: torch.Tensor) -> torch.Tensor:
    """Variance of skin-region texture (losses.py:86-98).
    texture (B, N, 3); skin_mask (N,)."""
    mask = skin_mask.reshape(1, -1, 1)
    denom = mask.sum().clamp_min(1.0)
    mean = (texture * mask).sum(dim=1, keepdim=True) / denom
    return (((texture - mean) * mask) ** 2).sum() \
        / (texture.shape[0] * denom)
