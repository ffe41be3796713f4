"""ArcFace face-recognition training in plain PyTorch, for an arcface
configuration dict: the iresnet trunk (`F.conv2d`, BatchNorm written out
with the batch's statistics, PReLU, flatten → FC → BatchNorm1d),
PartialFC's class sampling by its written rule, the margin logits over the
sampled rows materialised whole and their softmax cross-entropy, the
backbone's gradient clip and SGD, and the head's row SGD written out,
touching the sampled rows alone. Imports nothing of the port.

`rnd`, where given, rounds the operands of every convolution and product
(the control's TF32 written out, `round_tf32`, on a device without it).

The tree is the benchmark's (`models/arcface.spec`): "backbone" (the
trunk's parameters), "batch_stats" (BatchNorm's running moments) and
"fc_weight", the (classes, d) table of class centres.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..counts.flash_ce import sampled
from ..counts.iresnet import LAYERS


# -- the trunk ---------------------------------------------------------------------


def batch_norm(p, st, x, net):
    """Training BatchNorm over (B, C, H, W) or (B, C): the batch's mean and
    biased variance normalise x; the running moments move by the
    configuration's momentum toward them. → (y, new moments)."""
    dims = (0, 2, 3) if x.dim() == 4 else (0,)
    shape = (1, -1, 1, 1) if x.dim() == 4 else (1, -1)
    mean = x.mean(dims)
    xc = x - mean.view(shape)
    var = xc.square().mean(dims)
    y = xc * (p["scale"] * torch.rsqrt(var + net["bn_eps"])).view(shape) \
        + p["bias"].view(shape)
    m = net["bn_momentum"]
    with torch.no_grad():
        new = {"mean": (1 - m) * st["mean"] + m * mean,
               "var": (1 - m) * st["var"] + m * var}
    return y, new


def prelu(alpha, x):
    return torch.where(x > 0, x, alpha.view(1, -1, 1, 1) * x)


def round_tf32(x):
    """x rounded to TF32's 10-bit mantissa, to nearest, ties to even; its
    gradient passes through unrounded."""
    with torch.no_grad():
        bits = x.detach().contiguous().view(torch.int32)
        bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
        r = bits.view(torch.float32)
    return x + (r - x).detach()


def _same(x):
    return x


def conv(x, w, stride=1, rnd=_same):
    return F.conv2d(rnd(x), rnd(w), None, stride, w.shape[-1] // 2)


def block(p, st, x, stride, net, rnd=_same):
    """BN → 3×3 → BN → PReLU → 3×3 (strided) → BN, plus the shortcut (a
    strided 1×1 and BN where the shape changes)."""
    new = {}
    out, new["bn1"] = batch_norm(p["bn1"], st["bn1"], x, net)
    out = conv(out, p["conv1"], rnd=rnd)
    out, new["bn2"] = batch_norm(p["bn2"], st["bn2"], out, net)
    out = prelu(p["prelu"]["alpha"], out)
    out = conv(out, p["conv2"], stride, rnd)
    out, new["bn3"] = batch_norm(p["bn3"], st["bn3"], out, net)
    if "down_conv" in p:
        idn, new["down_bn"] = batch_norm(p["down_bn"], st["down_bn"],
                                         conv(x, p["down_conv"], stride, rnd),
                                         net)
    else:
        idn = x
    return out + idn, new


def embed(p, st, images, net, rnd=_same):
    """(B, size, size, 3) crops → ((B, d) embeddings, new running moments)."""
    new = {}
    h = conv(images.permute(0, 3, 1, 2), p["stem_conv"], rnd=rnd)
    h, new["stem_bn"] = batch_norm(p["stem_bn"], st["stem_bn"], h, net)
    h = prelu(p["stem_prelu"]["alpha"], h)
    for stage, n in enumerate(LAYERS[net["name"]]):
        for i in range(n):
            k = f"s{stage}_b{i}"
            h, new[k] = block(p[k], st[k], h, 2 if i == 0 else 1, net, rnd)
    h, new["bn2"] = batch_norm(p["bn2"], st["bn2"], h, net)
    h = rnd(h.flatten(1)) @ rnd(p["fc"]["weight"]).T + p["fc"]["bias"]
    h, new["features_bn"] = batch_norm(p["features_bn"], st["features_bn"],
                                       h, net)
    return h, new


# -- the head ------------------------------------------------------------------------


def sample(labels, draw, k: int):
    """The sorted class indices a step samples: every class of the batch's
    labels, then the other classes in descending order of `draw` (one
    uniform draw a class), a tie going to the lower class index, up to k
    in all."""
    n = draw.shape[0]
    positive = torch.unique(labels)
    is_positive = torch.zeros(n, dtype=torch.bool, device=draw.device)
    is_positive[positive] = True
    order = torch.sort(draw, descending=True, stable=True).indices
    negative = order[~is_positive[order]][:k - positive.numel()]
    return torch.sort(torch.cat([positive, negative])).values


def margin_ce(emb, rows, labels, index, head, rnd=_same):
    """The mean softmax cross-entropy of s · cos over the sampled rows, the
    target's cosine t replaced by cos(m1·θ + m2) − m3 (here m1 = 1, m2 = 0:
    t − m3), with every (B, k) logit materialised."""
    m1, m2, m3 = head["margin_list"]
    if (m1, m2) != (1.0, 0.0):
        raise NotImplementedError("the reference writes out m1 = 1, m2 = 0")
    ne = emb / emb.norm(dim=1, keepdim=True)
    nw = rows / rows.norm(dim=1, keepdim=True)
    cos = (rnd(ne) @ rnd(nw).T).clamp(-1.0, 1.0)
    col = torch.searchsorted(index, labels)[:, None]
    logits = head["s"] * cos.scatter(1, col, cos.gather(1, col) - m3)
    return (logits.logsumexp(1) - logits.gather(1, col)[:, 0]).mean()


# -- the step ----------------------------------------------------------------------------


def poly_lr(train: dict, count: int) -> float:
    """The poly(2) schedule with linear warm-up at update number count."""
    warm, total = train["warmup_steps"], train["total_steps"]
    if count < warm:
        return train["lr"] * count / max(warm, 1)
    frac = 1.0 - (count - warm) / max(total - warm, 1)
    return train["lr"] * min(max(frac, 0.0), 1.0) ** 2


class Step:
    """SGD on a tree: the backbone's momentum for each trained leaf and
    the table's, zero at the start."""

    def __init__(self, config: dict, tree: dict, params: list, rnd=None):
        self.config, self.tree, self.params = config, tree, params
        self.rnd = rnd or _same
        self.momentum = [torch.zeros_like(p) for p in params]
        self.table_momentum = torch.zeros_like(tree["fc_weight"])
        self.count = 0

    def __call__(self, images, labels, draw):
        """One step on a batch with the classes' draw → the loss."""
        cfg, tree = self.config, self.tree
        net, head, t = cfg["network"], cfg["head"], cfg["train"]
        index = sample(labels, draw, sampled(head["num_classes"],
                                             head["sample_rate"],
                                             labels.shape[0]))
        rows = tree["fc_weight"][index].requires_grad_(True)
        emb, new_stats = embed(tree["backbone"], tree["batch_stats"], images,
                               net, self.rnd)
        loss = margin_ce(emb, rows, labels, index, head, self.rnd)
        *grads, g_rows = torch.autograd.grad(loss, self.params + [rows])
        lr, mu, wd = poly_lr(t, self.count), t["momentum"], t["weight_decay"]
        with torch.no_grad():
            norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
            clip = t["clip_grad_norm"]
            scale = torch.where(norm < clip, torch.ones_like(norm),
                                clip / norm)
            for p, m, g in zip(self.params, self.momentum, grads):
                m.mul_(mu).add_(g * scale + wd * p)
                p.sub_(lr * m)
            buf = mu * self.table_momentum[index] + g_rows + wd * rows
            tree["fc_weight"][index] = rows - lr * buf
            self.table_momentum[index] = buf
            _store(tree["batch_stats"], new_stats)
        self.count += 1
        return loss.detach()


def _store(stats: dict, new: dict):
    for k, v in new.items():
        if isinstance(v, dict):
            _store(stats[k], v)
        else:
            stats[k].copy_(v)
