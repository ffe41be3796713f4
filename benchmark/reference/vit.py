"""ArcFace ViT training in plain PyTorch, for an arcface_vit configuration
dict: arcface_torch's `backbones/vit.py` forward (the patch embedding of
the top-left `crop`² as a product over each flattened patch, MAE-style
random masking, pre-norm blocks with `F.layer_norm`, a bias-free qkv, the
softmax of the scaled scores materialised whole, a ReLU6 MLP, stochastic
depth on both branches, the final norm, the mask tokens put back, and
the flatten-all-tokens head with its two BatchNorm1d), PartialFC's class
draw and margin cross-entropy (`reference/arcface.py`), the backbone's
gradient clip, and AdamW written out on the trunk and on the sampled rows
of the table and of its two moments alone. Imports nothing of the port.

The randomness comes from the step's generator in this order: the masking
noise, then for each block whose drop-path rate is above 0 the attention
branch's and the MLP branch's keep draws, then the class draw.

`rnd`, where given, rounds the operands of every product (the control's
TF32 written out, `arcface.round_tf32`, on a device without it).

The tree is the benchmark's (`models/arcface_vit.spec`): "backbone",
"batch_stats" (the head's two BatchNorm1d's running moments) and
"fc_weight", the (classes, d) table of class centres.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..counts.flash_ce import sampled
from ..counts.vit import kept, tokens
from .arcface import _same, _store, batch_norm, margin_ce, poly_lr, sample


def linear(p, x, rnd=_same):
    y = rnd(x) @ rnd(p["weight"]).T
    return y + p["bias"] if "bias" in p else y


def layer_norm(p, x, net):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"],
                        net["ln_eps"])


def drop_path(x, rate: float, gen):
    """Each sample's branch kept with probability 1 − rate and scaled by
    1 / (1 − rate), or zeroed."""
    keep = 1.0 - rate
    u = torch.rand((x.shape[0], 1, 1), generator=gen, device=x.device)
    return x * (u < keep).to(x.dtype) / keep


def rates(net: dict) -> list[float]:
    """Each block's drop-path rate, linear from 0 to `drop_path_rate`."""
    depth = net["depth"]
    return [net["drop_path_rate"] * i / max(depth - 1, 1)
            for i in range(depth)]


def block(p, x, rate: float, net, gen, rnd=_same):
    """x + drop(proj(attention(ln1 x))), then
    + drop(fc2(relu6(fc1(ln2 x))))."""
    b, n, dim = x.shape
    heads = net["heads"]
    hd = dim // heads
    qkv = linear(p["qkv"], layer_norm(p["ln1"], x, net), rnd)
    q, k, v = qkv.view(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    att = torch.softmax(rnd(q) @ rnd(k).transpose(-1, -2) / math.sqrt(hd),
                        dim=-1)
    y = (rnd(att) @ rnd(v)).transpose(1, 2).reshape(b, n, dim)
    y = linear(p["proj"], y, rnd)
    if rate > 0:
        y = drop_path(y, rate, gen)
    x = x + y
    y = linear(p["fc1"], layer_norm(p["ln2"], x, net), rnd).clamp(0.0, 6.0)
    y = linear(p["fc2"], y, rnd)
    if rate > 0:
        y = drop_path(y, rate, gen)
    return x + y


def embed(p, st, images, net, gen, rnd=_same):
    """(B, size, size, 3) crops → ((B, d) embeddings, the head's new running
    moments), in training: masking and drop path on."""
    b, c, patch = images.shape[0], net["crop"], net["patch"]
    g = c // patch
    n = tokens(net)
    x = images[:, :c, :c].reshape(b, g, patch, g, patch, 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, n, patch * patch * 3)
    tok = linear(p["patch_embed"], x, rnd) + p["pos_embed"]
    noise = torch.rand((b, n), generator=gen, device=tok.device)
    shuffle = torch.argsort(noise, dim=1)
    restore = torch.argsort(shuffle, dim=1)
    k, dim = kept(net, True), tok.shape[-1]
    tok = tok.gather(1, shuffle[:, :k, None].expand(b, k, dim))
    for i, rate in enumerate(rates(net)):
        tok = block(p[f"blk{i}"], tok, rate, net, gen, rnd)
    tok = layer_norm(p["norm"], tok, net)
    tok = torch.cat([tok, p["mask_token"].expand(b, n - k, dim)], dim=1)
    tok = tok.gather(1, restore[..., None].expand(b, n, dim))
    bn = {"bn_eps": net["bn_eps"], "bn_momentum": net["bn_momentum"]}
    new = {}
    h = linear(p["head0"], tok.reshape(b, n * dim), rnd)
    h, new["head0_bn"] = batch_norm(p["head0_bn"], st["head0_bn"], h, bn)
    h = linear(p["head1"], h, rnd)
    h, new["head1_bn"] = batch_norm(p["head1_bn"], st["head1_bn"], h, bn)
    return h, new


def adamw(p, m, v, g, lr: float, t: int, train: dict):
    """One AdamW update of p in place (decoupled decay, bias correction at
    update t ≥ 1): m, v ← β-averages of g, g²; p ← p − lr · (m̂ / (√v̂ + ε) +
    λ · p). → the new (p, m, v)."""
    b1, b2, eps = train["betas"][0], train["betas"][1], train["eps"]
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    step = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps)
    return p - lr * (step + train["weight_decay"] * p), m, v


class Step:
    """AdamW on a tree: the trunk's two moments for each trained leaf and
    the table's, zero at the start."""

    def __init__(self, config: dict, tree: dict, params: list, rnd=None):
        self.config, self.tree, self.params = config, tree, params
        self.rnd = rnd or _same
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.table_m = torch.zeros_like(tree["fc_weight"])
        self.table_v = torch.zeros_like(tree["fc_weight"])
        self.count = 0

    def __call__(self, images, labels, gen):
        """One step on a batch, drawing from `gen` → the loss."""
        cfg, tree = self.config, self.tree
        net, head, t = cfg["network"], cfg["head"], cfg["train"]
        emb, new_stats = embed(tree["backbone"], tree["batch_stats"], images,
                               net, gen, self.rnd)
        draw = torch.rand((head["num_classes"],), generator=gen,
                          device=gen.device)
        index = sample(labels, draw, sampled(head["num_classes"],
                                             head["sample_rate"],
                                             labels.shape[0]))
        rows = tree["fc_weight"][index].requires_grad_(True)
        loss = margin_ce(emb, rows, labels, index, head, self.rnd)
        *grads, g_rows = torch.autograd.grad(loss, self.params + [rows])
        lr, n = poly_lr(t, self.count), self.count + 1
        with torch.no_grad():
            # each leaf's norm, then theirs: one fp32 sum of the 85 M squares
            # of head0's weight would lose a part in a thousand
            norm = torch.stack([g.norm() for g in grads]).norm()
            clip = t["clip_grad_norm"]
            scale = torch.where(norm < clip, torch.ones_like(norm),
                                clip / norm)
            for i, (p, g) in enumerate(zip(self.params, grads)):
                new, self.m[i], self.v[i] = adamw(p, self.m[i], self.v[i],
                                                  g * scale, lr, n, t)
                p.copy_(new)
            new, m, v = adamw(rows.detach(), self.table_m[index],
                              self.table_v[index], g_rows, lr, n, t)
            tree["fc_weight"][index] = new
            self.table_m[index], self.table_v[index] = m, v
            _store(tree["batch_stats"], new_stats)
        self.count += 1
        return loss.detach()
