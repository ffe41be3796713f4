"""ViT face-embedding backbones: vit_t/s/b/l and the WebFace42M drop-path
and mask variants (port of hfa_gp_tpu/models/arcface/vit.py).

A stride-9 patch embedding over the top-left 108² of a 112² crop (12 × 12
= 144 tokens), pre-norm transformer blocks with a bias-free qkv and a
ReLU6 MLP, per-block stochastic depth on the linear schedule
0 → drop_path_rate, MAE-style random token masking in training with the
mask token restored after the final norm, and a flatten-all-tokens head:
Linear(dim·144 → dim, no bias) → BN1d (eps 2e-5) → Linear(dim → emb, no
bias) → BN1d.

Parameters keep the JAX package's keys and layouts: every linear weight
is (out, in) in both packages, and the patch embedding is a linear layer
over the patch flattened as JAX flattens it, (patch row, patch column,
channel), so a JAX tree carries over unchanged. Attention is written as
JAX writes it (matmul, softmax, matmul) in fp32 whatever the trunk's
dtype; 144 tokens need no fused kernel, and the plain form keeps parity.
The head runs in fp32.

In training the randomness comes from a `torch.Generator` on the input's
device (JAX takes a key), drawn in a fixed order: the masking noise, then
for each block with a drop-path rate above 0 the attention branch's and
the MLP branch's per-sample keep masks.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ...utils.convert import ParamTree
from .norm import batch_norm

VIT_CONFIGS = {
    # name: (patch, dim, depth, heads, mlp_ratio, drop_path, mask_ratio)
    "vit_t": (9, 256, 12, 8, 4.0, 0.1, 0.1),
    "vit_t_dp005_mask0": (9, 256, 12, 8, 4.0, 0.05, 0.0),
    "vit_s": (9, 512, 12, 8, 4.0, 0.1, 0.1),
    "vit_s_dp005_mask_0": (9, 512, 12, 8, 4.0, 0.05, 0.0),
    "vit_b": (9, 512, 24, 8, 4.0, 0.1, 0.1),
    "vit_b_dp005_mask_005": (9, 512, 24, 8, 4.0, 0.05, 0.05),
    # the reference ships vit_l only as the dp005_mask_005 variant
    "vit_l": (9, 768, 24, 8, 4.0, 0.05, 0.05),
    "vit_l_dp005_mask_005": (9, 768, 24, 8, 4.0, 0.05, 0.05),
}

INPUT_SIZE = 108          # 12 × 12 patches of 9: the reference conv's reach
_BN_EPS = 2e-5            # the head's BN1d
_LN_EPS = 1e-6


def _trunc_normal(g: torch.Generator, shape, std: float = 0.02):
    return torch.nn.init.trunc_normal_(torch.empty(shape), std=std,
                                       a=-2.0 * std, b=2.0 * std,
                                       generator=g)


def _init_linear(g, cin, cout, bias=True):
    p = {"weight": _trunc_normal(g, (cout, cin))}
    if bias:
        p["bias"] = torch.zeros(cout)
    return p


def _linear(p, x: torch.Tensor) -> torch.Tensor:
    b = p.get("bias")
    return F.linear(x, p["weight"].to(x.dtype),
                    None if b is None else b.to(x.dtype))


def _init_ln(dim):
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def _ln(p, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in x's dtype, written as the JAX package writes it."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + _LN_EPS) * p["scale"].to(x.dtype) \
        + p["bias"].to(x.dtype)


def _init_bn1d(c):
    return ({"scale": torch.ones(c), "bias": torch.zeros(c)},
            {"mean": torch.zeros(c), "var": torch.ones(c)})


def init_vit(generator: torch.Generator, name: str = "vit_s",
             embedding_dim: int = 512, device: torch.device | str = "cpu"
             ) -> tuple[ParamTree, ParamTree]:
    """(params, batch_stats) on `device`, drawn on the CPU from
    `generator`."""
    patch, dim, depth, _, mlp_ratio, _, _ = VIT_CONFIGS[name]
    n_tokens = (INPUT_SIZE // patch) ** 2
    hidden = int(dim * mlp_ratio)
    g = generator
    p: dict[str, Any] = {
        "patch_embed": _init_linear(g, patch * patch * 3, dim),
        "pos_embed": _trunc_normal(g, (n_tokens, dim)),
        "mask_token": _trunc_normal(g, (dim,)),
    }
    for i in range(depth):
        p[f"blk{i}"] = {
            "ln1": _init_ln(dim),
            "qkv": _init_linear(g, dim, dim * 3, bias=False),
            "proj": _init_linear(g, dim, dim),
            "ln2": _init_ln(dim),
            "fc1": _init_linear(g, dim, hidden),
            "fc2": _init_linear(g, hidden, dim),
        }
    p["norm"] = _init_ln(dim)
    p["head0"] = _init_linear(g, dim * n_tokens, dim, bias=False)
    p["head0_bn"], bn0 = _init_bn1d(dim)
    p["head1"] = _init_linear(g, dim, embedding_dim, bias=False)
    p["head1_bn"], bn1 = _init_bn1d(embedding_dim)
    st = {"head0_bn": bn0, "head1_bn": bn1}
    return ParamTree(p).to(device), ParamTree(st).to(device)


def random_masking(tok: torch.Tensor, len_keep: int,
                   generator: torch.Generator):
    """MAE masking per sample: argsort uniform noise and keep the first
    `len_keep` tokens. Returns (kept tokens (B, len_keep, D), ids_restore
    (B, N)), where gathering [kept, mask tokens] by ids_restore puts every
    token back at its place."""
    b, n, d = tok.shape
    noise = torch.rand((b, n), generator=generator, device=tok.device)
    ids_shuffle = torch.argsort(noise, dim=1)
    ids_restore = torch.argsort(ids_shuffle, dim=1)
    ids_keep = ids_shuffle[:, :len_keep]
    kept = torch.gather(tok, 1, ids_keep[..., None].expand(b, len_keep, d))
    return kept, ids_restore


def restore_masked(tok: torch.Tensor, mask_token: torch.Tensor,
                   ids_restore: torch.Tensor) -> torch.Tensor:
    """The kept tokens (B, K, D) and `mask_token` (D,) in the N − K masked
    places → (B, N, D) in the original token order."""
    b, k, d = tok.shape
    n = ids_restore.shape[1]
    fill = mask_token.to(tok.dtype).expand(b, n - k, d)
    full = torch.cat([tok, fill], dim=1)
    return torch.gather(full, 1, ids_restore[..., None].expand(b, n, d))


def drop_path(x: torch.Tensor, rate: float,
              generator: torch.Generator) -> torch.Tensor:
    """Stochastic depth: each sample's branch kept with probability
    1 − rate and then scaled by 1 / (1 − rate), or zeroed."""
    keep = 1.0 - rate
    u = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1), generator=generator,
                   device=x.device)
    return x * (u < keep).to(x.dtype) / keep


def vit_apply(params, x: torch.Tensor, name: str = "vit_s",
              dtype: torch.dtype = torch.float32, *, batch_stats,
              train: bool = False,
              generator: torch.Generator | None = None):
    """x (B, H, W, 3) → (B, embedding_dim) fp32 [, new_batch_stats when
    train]. H and W are cropped top-left to 108. `train` turns drop path
    and masking on, with randomness from `generator` (needed then)."""
    patch, dim, depth, heads, _, drop_path_rate, mask_ratio = \
        VIT_CONFIGS[name]
    b, h, _, _ = x.shape
    if h != INPUT_SIZE:
        x = x[:, :INPUT_SIZE, :INPUT_SIZE]
    g_ = INPUT_SIZE // patch
    n_tokens = g_ * g_
    x = x.to(dtype).reshape(b, g_, patch, g_, patch, 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, n_tokens, -1)
    tok = _linear(params["patch_embed"], x) + params["pos_embed"].to(dtype)

    masking = train and mask_ratio > 0
    if masking:
        len_keep = int(n_tokens * (1 - mask_ratio))
        tok, ids_restore = random_masking(tok, len_keep, generator)

    dpr = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
    hd = dim // heads
    scale = 1.0 / math.sqrt(hd)
    for i in range(depth):
        blk = params[f"blk{i}"]
        y = _ln(blk["ln1"], tok)
        qkv = _linear(blk["qkv"], y).reshape(b, -1, 3, heads, hd).float()
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        att = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
        y = (att @ v).transpose(1, 2).reshape(b, -1, dim)
        y = _linear(blk["proj"], y.to(dtype))
        if train and dpr[i] > 0:
            y = drop_path(y, dpr[i], generator)
        tok = tok + y
        y = _ln(blk["ln2"], tok)
        y = _linear(blk["fc2"], torch.clamp(_linear(blk["fc1"], y), 0.0,
                                            6.0))
        if train and dpr[i] > 0:
            y = drop_path(y, dpr[i], generator)
        tok = tok + y

    tok = _ln(params["norm"], tok.float())
    if masking:
        tok = restore_masked(tok, params["mask_token"], ids_restore)

    flat = tok.reshape(b, n_tokens * dim)
    st = batch_stats
    new: dict[str, Any] = {}
    emb = _linear(params["head0"], flat)
    emb, new["head0_bn"] = batch_norm(params["head0_bn"], st["head0_bn"],
                                      emb, train, _BN_EPS)
    emb = _linear(params["head1"], emb)
    emb, new["head1_bn"] = batch_norm(params["head1_bn"], st["head1_bn"],
                                      emb, train, _BN_EPS)
    if train:
        return emb, new
    return emb
