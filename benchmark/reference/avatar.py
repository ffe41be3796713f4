"""The HFA-GP avatar in plain PyTorch: the RGB encoder, the QR subspace,
AudioNet and AudioAttNet with the weights MLP, LPIPS (AlexNet), the RGB
fitting loss and Adam. A frozen copy of the port's plain paths for one
configuration dict, importing nothing of the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import eg3d, ops

BLUR = (1, 3, 3, 1)
AUDIO_SLOPE = 0.02
LPIPS_CONVS = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
               (256, 3, 1, 1), (256, 3, 1, 1))
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


# -- RGB encoder ----------------------------------------------------------------


def _conv_layer(p, x, *, down=False, act=True):
    k = p["weight"].shape[-1]
    if down:
        t = len(BLUR) - 2 + k - 1
        x = ops.upfirdn2d(x, ops.fir_kernel(BLUR), pad=((t + 1) // 2, t // 2))
        y = ops.equal_conv2d(x, p["weight"], p.get("bias"), stride=2)
    else:
        y = ops.equal_conv2d(x, p["weight"], p.get("bias"), padding=k // 2)
    if not act:
        return y
    if "act_bias" in p:
        return ops.fused_leaky_relu(y, p["act_bias"])
    return F.leaky_relu(y, 0.2)


def linear_stack(p, x):
    i = 0
    while f"fc{i}" in p:
        x = ops.equal_linear(x, p[f"fc{i}"]["weight"], p[f"fc{i}"]["bias"])
        i += 1
    return x


def encoder(p, image):
    """(B, size, size, 3) → driving weights (B, dim_shape)."""
    a = p["net_app"]
    h = _conv_layer(a["stem"], image.permute(0, 3, 1, 2))
    i = 0
    while f"res{i}" in a:
        r = a[f"res{i}"]
        out = _conv_layer(r["conv2"], _conv_layer(r["conv1"], h), down=True)
        h = (out + _conv_layer(r["skip"], h, down=True, act=False)) \
            / math.sqrt(2.0)
        i += 1
    h = ops.equal_conv2d(h, a["final"]["weight"])[:, :, 0, 0]
    return linear_stack(p["fc"], h)


def latent(sub, weights, dim):
    """QR-orthonormalised bases mixed by the weights, plus delta →
    (B, num_ws, dim)."""
    q = torch.linalg.qr((sub["bases"] + 1e-8).T).Q
    return (weights @ q.T).reshape(weights.shape[0], -1, dim) \
        + sub["delta"].reshape(1, -1, dim)


# -- audio ---------------------------------------------------------------------------


def _conv1d(p, x, stride):
    return F.leaky_relu(F.conv1d(x, p["weight"], p["bias"], stride=stride,
                                 padding=1), AUDIO_SLOPE)


def audio_net(p, x, win_size):
    half = win_size // 2
    x = x[:, 8 - half:8 + half].transpose(1, 2)
    for i in range(4):
        x = _conv1d(p[f"conv{i}"], x, 2)
    x = F.leaky_relu(F.linear(x[:, :, 0], p["fc0"]["weight"],
                              p["fc0"]["bias"]), AUDIO_SLOPE)
    return F.linear(x, p["fc1"]["weight"], p["fc1"]["bias"])


def audio_att_net(p, codes, att_dim=32):
    y = codes[:, :, :att_dim].transpose(1, 2)
    for i in range(5):
        y = _conv1d(p[f"conv{i}"], y, 1)
    s = F.linear(y[:, 0], p["att_fc"]["weight"], p["att_fc"]["bias"])
    return (torch.softmax(s, dim=1)[:, :, None] * codes).sum(1)


# -- the avatars -----------------------------------------------------------------------


def rgb_frames(params, cfg: dict, image, label):
    """The RGB avatar: image (B, size, size, 3) → (B, 512, 512, 3)."""
    w = encoder(params["encoder"], image)
    return eg3d.synthesis(params["generator"], cfg["eg3d"],
                          latent(params["subspace"], w, cfg["encoder"]["w_dim"]),
                          label)


def audio_frames(params, cfg: dict, windows, label):
    """The audio avatar, smoothed: windows (B, smo_size, win, 29) →
    (B, 512, 512, 3)."""
    a = cfg["audio"]
    b, smo, win, c = windows.shape
    codes = audio_net(params["audnet"], windows.reshape(b * smo, win, c),
                      a["win_size"]).reshape(b, smo, -1)
    code = audio_att_net(params["audattnet"], codes)
    m = params["model"]
    w = linear_stack(m["weights_mlp"], code)
    return eg3d.synthesis(m["generator"], cfg["eg3d"],
                          latent(m["subspace"], w, cfg["encoder"]["w_dim"]),
                          label)


# -- LPIPS, the fitting loss, Adam -------------------------------------------------------


def lpips(p, img0, img1):
    """(B, H, W, 3) pairs in [-1, 1] → (B,) distances."""
    shift = torch.tensor(LPIPS_SHIFT, dtype=img0.dtype, device=img0.device)
    scale = torch.tensor(LPIPS_SCALE, dtype=img0.dtype, device=img0.device)

    def feats(x):
        x = ((x - shift) / scale).permute(0, 3, 1, 2)
        out = []
        for i, (_, _, stride, pad) in enumerate(LPIPS_CONVS):
            x = F.relu(F.conv2d(x, p[f"conv{i}"]["weight"],
                                p[f"conv{i}"]["bias"], stride=stride,
                                padding=pad))
            out.append(x)
            if i < 2:
                x = F.max_pool2d(x, 3, 2)
        return out

    def unit(x):
        return x / (x.square().sum(1, keepdim=True).sqrt() + 1e-10)

    total = 0.0
    for i, (a, b) in enumerate(zip(feats(img0), feats(img1))):
        d = (unit(a) - unit(b)).square()
        w = F.relu(p[f"lin{i}"]["weight"])
        total = total + (d * w[None, :, None, None]).sum(1).mean(dim=(1, 2))
    return total


def rgb_loss(params, lpips_params, cfg: dict, image, label):
    """L2 + LPIPS between the frame and the render pooled to its size."""
    gen = ops.avg_pool_to(rgb_frames(params, cfg, image, label),
                          cfg["encoder"]["size"])
    return (image - gen).square().mean() + lpips(lpips_params, image,
                                                 gen).mean()


class Adam:
    """torch.optim.Adam's arithmetic (and optax.adam's), written out."""

    def __init__(self, leaves, lr, betas, eps):
        self.leaves, self.lr, self.eps = leaves, lr, eps
        self.b1, self.b2 = betas
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            m.lerp_(g, 1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.addcdiv_(m, (v.sqrt() / math.sqrt(c2)).add_(self.eps),
                       value=-self.lr / c1)
