"""Differentiable affine warp + ArcFace crop alignment (port of
hfa_gp_tpu/preprocess/warp.py).

Rebuilds the reference's kornia `warp_affine` usage
(eg3d-pose-detection/models/losses.py:4-10 `resize_n_crop`,
models/networks.py:107-126 RecogNetWrapper) and the `estimate_norm`
similarity transform that feeds it (upstream Deep3DFaceRecon
`util.preprocess`). The warp is the direct four-tap bilinear form,
differentiable with respect to both the image and M; `estimate_norm` is
the closed-form Umeyama similarity (skimage's SimilarityTransform).
Images are NHWC, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

# Canonical ArcFace 112x112 five-point targets (insightface convention,
# consumed by Deep3DFaceRecon util/preprocess.py estimate_norm).
ARCFACE_5PTS = np.array([
    [38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
    [41.5493, 92.3655], [70.7299, 92.2041]], dtype=np.float32)


def extract_5p(lm68: torch.Tensor) -> torch.Tensor:
    """68-point landmarks → 5 points (eye centres, nose, mouth corners)."""
    lm = lm68[..., [30, 36, 39, 42, 45, 48, 54], :]
    left_eye = (lm[..., 1, :] + lm[..., 2, :]) / 2
    right_eye = (lm[..., 3, :] + lm[..., 4, :]) / 2
    return torch.stack([left_eye, right_eye, lm[..., 0, :],
                        lm[..., 5, :], lm[..., 6, :]], dim=-2)


def umeyama_similarity(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Least-squares similarity (scale·R, t) mapping src → dst, closed form
    (Umeyama 1991). src/dst: (..., N, 2) → (..., 2, 3)."""
    mu_s = src.mean(dim=-2, keepdim=True)
    mu_d = dst.mean(dim=-2, keepdim=True)
    sc = src - mu_s
    dc = dst - mu_d
    cov = torch.einsum("...ni,...nj->...ij", dc, sc) / src.shape[-2]
    u, s, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u) * torch.linalg.det(vt)
    d = torch.stack([torch.ones_like(det), torch.sign(det)], dim=-1)
    r = u @ (d[..., :, None] * vt)
    var_s = (sc * sc).sum(dim=-1).mean(dim=-1)
    scale = (s * d).sum(dim=-1) / var_s.clamp_min(1e-12)
    sr = scale[..., None, None] * r
    t = mu_d.squeeze(-2) - torch.einsum("...ij,...j->...i", sr,
                                        mu_s.squeeze(-2))
    return torch.cat([sr, t[..., :, None]], dim=-1)


def estimate_norm(lm: torch.Tensor, h: int) -> torch.Tensor:
    """Landmarks → (B, 2, 3) affine M aligning the face to the 112² ArcFace
    crop. lm: (B, 68, 2) or (B, 5, 2) in image coords with y pointing UP
    (the recon convention); `h` flips it to raster coords first
    (util/preprocess.py estimate_norm: lm[:, -1] = H-1-lm[:, -1])."""
    if lm.shape[-2] == 68:
        lm = extract_5p(lm)
    lm = torch.stack([lm[..., 0], h - 1 - lm[..., 1]], dim=-1)
    dst = torch.as_tensor(ARCFACE_5PTS, dtype=lm.dtype, device=lm.device) \
        .expand(lm.shape[:-2] + (5, 2))
    return umeyama_similarity(lm, dst)


def _invert_affine(m: torch.Tensor) -> torch.Tensor:
    """(..., 2, 3) → inverse (..., 2, 3). A degenerate M (|det| ≤ 1e-12)
    maps every pixel far out of bounds, so its warp is zero, in value and
    gradient, and not NaN."""
    a = m[..., :2]
    t = m[..., 2]
    det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    ok = det.abs() > 1e-12
    safe_det = torch.where(ok, det, torch.ones_like(det))
    adj = torch.stack([
        torch.stack([a[..., 1, 1], -a[..., 0, 1]], dim=-1),
        torch.stack([-a[..., 1, 0], a[..., 0, 0]], dim=-1)], dim=-2)
    ainv = adj / safe_det[..., None, None]
    tinv = -torch.einsum("...ij,...j->...i", ainv, t)
    tinv = torch.where(ok[..., None], tinv, torch.full_like(tinv, -1e9))
    return torch.cat([ainv, tinv[..., :, None]], dim=-1)


def warp_affine(image: torch.Tensor, m: torch.Tensor, dsize: int
                ) -> torch.Tensor:
    """kornia.geometry.warp_affine for NHWC with align_corners=True:
    dst(p) = src(M⁻¹ p), bilinear, each tap outside the image reading zero.

    image (B, H, W, C); m (B, 2, 3) source→destination pixel transform;
    returns (B, dsize, dsize, C)."""
    b, h, w, c = image.shape
    minv = _invert_affine(m.to(torch.float32))
    ys, xs = torch.meshgrid(
        torch.arange(dsize, dtype=torch.float32, device=image.device),
        torch.arange(dsize, dtype=torch.float32, device=image.device),
        indexing="ij")
    grid = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).reshape(-1, 3)
    src = torch.einsum("bij,pj->bpi", minv, grid)               # (B, P, 2)
    sx, sy = src[..., 0], src[..., 1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx = (sx - x0)[..., None].to(image.dtype)
    fy = (sy - y0)[..., None].to(image.dtype)
    flat = image.reshape(b, h * w, c)

    def tap(xi, yi):
        inb = ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1))
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return v * inb[..., None].to(image.dtype)

    out = (tap(x0, y0) * (1 - fx) * (1 - fy)
           + tap(x0 + 1, y0) * fx * (1 - fy)
           + tap(x0, y0 + 1) * (1 - fx) * fy
           + tap(x0 + 1, y0 + 1) * fx * fy)
    return out.reshape(b, dsize, dsize, c)


def resize_n_crop(image: torch.Tensor, m: torch.Tensor,
                  dsize: int = 112) -> torch.Tensor:
    """losses.py:7-10 (NHWC)."""
    return warp_affine(image, m, dsize)


def perceptual_id_loss(recog_fn, image_a: torch.Tensor,
                       image_b: torch.Tensor, m: torch.Tensor,
                       dsize: int = 112) -> torch.Tensor:
    """PerceptualLoss.forward (losses.py:12-34) from images: warp both to
    the ArcFace crop, map [0,1] → [-1,1], embed with the frozen recognition
    net, 1 − cosine. `recog_fn`: (B, 112, 112, 3) → (B, D), for example
    `lambda x: iresnet.iresnet_apply(params, stats, x)`."""
    fa = recog_fn(2.0 * resize_n_crop(image_a, m, dsize) - 1.0)
    fb = recog_fn(2.0 * resize_n_crop(image_b, m, dsize) - 1.0)
    fa = fa / torch.linalg.vector_norm(fa, dim=-1,
                                       keepdim=True).clamp_min(1e-12)
    fb = fb / torch.linalg.vector_norm(fb, dim=-1,
                                       keepdim=True).clamp_min(1e-12)
    return (1.0 - (fa * fb).sum(dim=-1)).mean()
