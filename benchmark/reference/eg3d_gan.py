"""EG3D's GAN training in plain PyTorch, importing nothing of the port: the
tri-plane generator with random noise and jittered depths, EG3D's dual
discriminator over StyleGAN2's resnet blocks, the four phases of
StyleGAN2-ADA's loop as EG3D sets them (Gmain, Greg every 4, Dmain, Dreg
every 16), two lazily regularised Adams and the generator's EMA.

The synthesis reuses `eg3d.py` (modulated convolutions, torgb, the
renderer's lookups by `F.grid_sample`, the decoder, the march written
out, the SR head) and `ops.py` (the FIR as the stuffed, padded input and
a depthwise convolution); the discriminator's FIRs are that plain
`upfirdn2d`, its convolutions `F.conv2d`. Every draw of a step comes from
the generator the caller seeds, in this order: a phase's z, the label
indices, the swaps, each backbone layer's noise, then the coarse depths'
jitter and the fine samples' quantiles (Gmain, Dmain) or the density
points (Greg). The caller sets TF32 (off: the reference; on: the
control).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import eg3d, ops
from .eg3d import block_resolutions

PHASES = ("Gmain", "Greg", "Dmain", "Dreg")


# -- the generator ------------------------------------------------------------


def mapping(params, m: dict, z, c, num_ws: int, *, update_emas=False,
            w_avg_beta=0.995):
    x = z * torch.rsqrt(z.square().mean(-1, keepdim=True) + 1e-8)
    y = ops.fully_connected(c, params["embed"]["weight"],
                            params["embed"]["bias"])
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + 1e-8)
    x = torch.cat([x, y], dim=-1)
    for i in range(m["num_layers"]):
        fc = params[f"fc{i}"]
        x = ops.fully_connected(x, fc["weight"], fc["bias"], act="lrelu",
                                lr_mul=m["lr_multiplier"])
    if update_emas:
        with torch.no_grad():
            w_avg = params["w_avg"]
            w_avg.copy_(x.detach().mean(0).lerp(w_avg, w_avg_beta))
    return x[:, None].expand(-1, num_ws, -1)


def _layer(p, x, w, *, up, fir, clamp, g):
    y = ops.modulated_conv2d(x, p["weight"], eg3d._styles(p, w), up=up,
                             padding=p["weight"].shape[-1] // 2, fir=fir)
    noise = torch.randn((y.shape[0], 1, y.shape[2], y.shape[3]),
                        generator=g, device=g.device)
    y = y + noise * p["noise_strength"]
    return ops.bias_act(y, p["bias"], act="lrelu", clamp=clamp)


def _block(p, x, img, ws3, *, fir, clamp, g):
    i = 0
    if "const" in p:
        x = p["const"][None].expand(ws3.shape[0], -1, -1, -1)
    if "conv0" in p:
        x = _layer(p["conv0"], x, ws3[:, i], up=2, fir=fir, clamp=clamp, g=g)
        i += 1
    x = _layer(p["conv1"], x, ws3[:, i], up=1, fir=fir, clamp=clamp, g=g)
    y = eg3d.torgb(p["torgb"], x, ws3[:, i + 1], clamp=clamp)
    if img is None:
        return x, y
    return x, ops.upsample2d(img, ops.fir_kernel(fir)) + y


def backbone(params, bb: dict, ws, g):
    """The tri-plane backbone with random noise from g → (B, 3, H, W, C)."""
    x = img = None
    k = 0
    for res in block_resolutions(bb):
        n = 1 if res == 4 else 2
        w3 = ws[:, k:k + n + 1]
        if res == 4:
            w3 = torch.cat([w3, torch.zeros_like(w3[:, :1])], dim=1)
        x, img = _block(params[f"b{res}"], x, img, w3, fir=bb["fir"],
                        clamp=bb["conv_clamp"], g=g)
        k += n
    b, _, h, _ = img.shape
    return img.reshape(b, 3, -1, h, h).permute(0, 1, 3, 4, 2).contiguous()


def render(dec, rc: dict, planes, origins, dirs, g):
    """The importance render with EG3D's training jitter: each coarse depth
    moved into its bin by a uniform draw, the fine depths at uniform
    quantiles of the coarse weights (EG3D's `sample_pdf` with det=False)
    → features (B, R, C_out)."""
    b, r, _ = origins.shape
    n, nf = rc["depth_resolution"], rc["depth_resolution_importance"]
    jc = torch.rand((b, r, n, 1), generator=g, device=g.device)
    jf = torch.rand((b, r, nf), generator=g, device=g.device)

    def points(depths):
        k = depths.shape[2]
        pts = origins[:, :, None] + depths * dirs[:, :, None]
        rgb, sigma = eg3d.decoder(dec, rc, eg3d.sample_planes(
            planes, pts.reshape(b, -1, 3), rc["box_warp"]))
        return rgb.reshape(b, r, k, -1), sigma.reshape(b, r, k, 1)

    lo, hi = rc["ray_start"], rc["ray_end"]
    d_c = torch.linspace(lo, hi, n, device=origins.device)[
        None, None, :, None] + jc * ((hi - lo) / (n - 1))
    c_c, s_c = points(d_c)
    _, _, w = eg3d.march(c_c, s_c, d_c, rc["white_back"])
    z = d_c.reshape(b * r, n)
    ws = eg3d._smooth(w.reshape(b * r, -1))[:, 1:-1]
    mid = 0.5 * (z[:, :-1] + z[:, 1:])
    d_f = eg3d._pdf_sample(mid, ws, jf.reshape(b * r, nf)).detach() \
        .reshape(b, r, nf, 1)
    c_f, s_f = points(d_f)
    d = torch.cat([d_c, d_f], 2)
    order = torch.sort(d[..., 0], dim=-1, stable=True).indices[..., None]
    d = d.gather(2, order)
    c = torch.cat([c_c, c_f], 2).gather(2, order.expand(-1, -1, -1,
                                                        c_c.shape[-1]))
    s = torch.cat([s_c, s_f], 2).gather(2, order)
    rgb, _, _ = eg3d.march(c, s, d, rc["white_back"])
    return rgb


def synthesis(params, cfg: dict, ws, label, g):
    """→ (image (B, 3, 512, 512), image_raw (B, 3, 128, 128)), NCHW."""
    rc = cfg["render"]
    b, res = ws.shape[0], rc["neural_rendering_resolution"]
    origins, dirs = eg3d.rays(label, res)
    planes = backbone(params["backbone"], cfg["backbone"], ws, g)
    feats = render(params["decoder"], rc, planes, origins, dirs, g)
    fimg = feats.permute(0, 2, 1).reshape(b, -1, res, res)
    img = eg3d.superresolution(params["superresolution"], cfg["sr"],
                               fimg[:, :3], fimg, ws)
    return img, fimg[:, :3]


# -- the discriminator ---------------------------------------------------------


def _channels(d: dict, res: int) -> int:
    return min(d["channel_base"] // res, d["channel_max"])


def _conv_layer(p, x, *, act, fir, gain=1.0, down=1, clamp=None):
    w = p["weight"]
    _, cin, k, _ = w.shape
    w = w * (1.0 / math.sqrt(cin * k * k))
    if down == 1:
        x = F.conv2d(x, w, padding=k // 2)
    else:
        f = len(fir)
        pad = (k // 2 + (f - down + 1) // 2, k // 2 + (f - down) // 2)
        if k == 1:
            x = F.conv2d(ops.upfirdn2d(x, fir, down=down, pad=pad), w)
        else:
            x = F.conv2d(ops.upfirdn2d(x, fir, pad=pad), w, stride=down)
    if "bias" in p:
        x = x + p["bias"].reshape(1, -1, 1, 1)
    if act == "lrelu":
        x = F.leaky_relu(x, 0.2) * (math.sqrt(2.0) * gain)
    else:
        x = x * gain
    return x if clamp is None else x.clamp(-clamp * gain, clamp * gain)


def _mbstd(x, group: int, f: int):
    n, c, h, w = x.shape
    gs = min(group, n)
    y = x.reshape(gs, -1, f, c // f, h, w)
    y = (y - y.mean(0)).square().mean(0)
    y = (y + 1e-8).sqrt().mean(dim=(2, 3, 4)).reshape(-1, f, 1, 1)
    return torch.cat([x, y.repeat(gs, 1, h, w)], dim=1)


def discriminator(params, d: dict, image, image_raw, c):
    """image (B, 3, R, R), image_raw (B, 3, r, r), label (B, 25) →
    logits (B, 1)."""
    fir = d["fir"]
    top = image.shape[-1]
    raw = F.interpolate(image_raw, size=(top, top), mode="bilinear",
                        align_corners=False, antialias=True)
    x = torch.cat([image, raw], dim=1)
    clamp, half = d["conv_clamp"], math.sqrt(0.5)
    x = _conv_layer(params[f"b{top}"]["fromrgb"], x, act="lrelu", fir=fir,
                    clamp=clamp)
    for res in [2 ** i for i in range(int(math.log2(top)), 2, -1)]:
        p = params[f"b{res}"]
        y = _conv_layer(p["skip"], x, act="linear", fir=fir, gain=half,
                        down=2)
        x = _conv_layer(p["conv0"], x, act="lrelu", fir=fir, clamp=clamp)
        x = _conv_layer(p["conv1"], x, act="lrelu", fir=fir, gain=half,
                        down=2, clamp=clamp)
        x = y + x
    m = params["mapping"]
    cmap = ops.fully_connected(c, m["embed"]["weight"], m["embed"]["bias"])
    cmap = cmap * torch.rsqrt(cmap.square().mean(-1, keepdim=True) + 1e-8)
    for i in range(d["mapping_layers"]):
        cmap = ops.fully_connected(cmap, m[f"fc{i}"]["weight"],
                                   m[f"fc{i}"]["bias"], act="lrelu",
                                   lr_mul=d["mapping_lr_multiplier"])
    e = params["b4"]
    x = _mbstd(x, d["mbstd_group_size"], d["mbstd_num_channels"])
    x = _conv_layer(e["conv"], x, act="lrelu", fir=fir, clamp=clamp)
    x = ops.fully_connected(x.flatten(1), e["fc"]["weight"], e["fc"]["bias"],
                            act="lrelu")
    x = ops.fully_connected(x, e["out"]["weight"], e["out"]["bias"])
    dim = _channels(d, 4)
    return (x * cmap).sum(1, keepdim=True) * (1.0 / math.sqrt(dim))


# -- the optimizer and the loop ------------------------------------------------


class Adam:
    """torch.optim.Adam's arithmetic, written out, with lazy
    regularisation's ratio; a leaf without a gradient is not stepped and
    its step count stays, as torch's Adam does with a `None` grad. NaN and
    infinite gradients are replaced first (0, ±1e5)."""

    def __init__(self, leaves, lr, betas, eps, interval):
        r = interval / (interval + 1)
        self.leaves, self.lr, self.eps = leaves, lr * r, eps
        self.b1, self.b2 = betas[0] ** r, betas[1] ** r
        self.t = [0] * len(leaves)
        self.m = [None] * len(leaves)
        self.v = [None] * len(leaves)

    @torch.no_grad()
    def step(self, grads):
        for i, (p, g) in enumerate(zip(self.leaves, grads)):
            if g is None:
                continue
            g = torch.nan_to_num(g, nan=0.0, posinf=1e5, neginf=-1e5)
            if self.m[i] is None:
                self.m[i], self.v[i] = torch.zeros_like(p), torch.zeros_like(p)
            self.t[i] += 1
            m, v = self.m[i], self.v[i]
            m.lerp_(g, 1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            c1 = 1 - self.b1 ** self.t[i]
            c2 = 1 - self.b2 ** self.t[i]
            p.addcdiv_(m, (v.sqrt() / math.sqrt(c2)).add_(self.eps),
                       value=-self.lr / c1)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


def is_buffer(path: str) -> bool:
    return path.endswith("w_avg") or path.endswith("noise_const")


class Trainer:
    """The loop on a G tree and a D tree (nested dicts of tensors, trained
    in place) for one configuration dict (`configs/<config>.json`)."""

    def __init__(self, config: dict, G: dict, D: dict):
        self.config, self.G, self.D = config, G, D
        self.G_ema = _clone(G)
        opt = config["optimizers"]
        self.g_leaves = [t for p, t in _flat(G) if not is_buffer(p)]
        self.d_leaves = [t for _, t in _flat(D)]
        for t in self.g_leaves + self.d_leaves:
            t.requires_grad_(True)
        sched = config["schedule"]
        self.adam_g = Adam(self.g_leaves, opt["G"]["lr"], opt["G"]["betas"],
                           opt["G"]["eps"], sched["Greg"])
        self.adam_d = Adam(self.d_leaves, opt["D"]["lr"], opt["D"]["betas"],
                           opt["D"]["eps"], sched["Dreg"])
        self.count = 0
        self.g_first = self.greg = None

    def _draw(self, g, pool, b, per_row=True):
        """z, c from the pool, c' swapped with the previous row's c row by
        row, or for the whole batch at once (Greg, as EG3D's loss)."""
        z = torch.randn((b, self.config["eg3d"]["mapping"]["z_dim"]),
                        generator=g, device=g.device)
        idx = torch.randint(pool.shape[0], (b,), generator=g, device=g.device)
        c = pool[idx]
        swap = torch.rand((b, 1) if per_row else (), generator=g,
                          device=g.device) \
            < self.config["loss"]["gpc_reg_prob"]
        return z, c, torch.where(swap, c.roll(1, 0), c)

    def _ws(self, z, c_map, update_emas=False):
        e = self.config["eg3d"]
        return mapping(self.G["mapping"], e["mapping"], z, c_map,
                       eg3d.num_ws(e["backbone"]), update_emas=update_emas,
                       w_avg_beta=self.config["loss"]["w_avg_beta"])

    def _d(self, image, raw, c):
        return discriminator(self.D, self.config["discriminator"], image,
                             raw, c)

    def _reals(self, real):
        image = real.permute(0, 3, 1, 2)
        res = self.config["eg3d"]["render"]["neural_rendering_resolution"]
        return image, F.interpolate(image, size=(res, res), mode="bilinear",
                                    align_corners=False, antialias=True)

    def phase(self, name, real, real_c, pool, g):
        """One phase's loss × its interval and its network's gradients
        (None where it reaches no leaf) → (loss terms, gradients)."""
        cfg, e, lo = self.config, self.config["eg3d"], self.config["loss"]
        gain, b = cfg["schedule"][name], real.shape[0]
        if name == "Gmain":
            z, c, cm = self._draw(g, pool, b)
            img, raw = synthesis(self.G, e, self._ws(z, cm), c, g)
            loss = F.softplus(-self._d(img, raw, c)).mean()
            terms = {"Gmain": loss}
        elif name == "Greg":
            z, _, cm = self._draw(g, pool, b, per_row=False)
            planes = backbone(self.G["backbone"], e["backbone"],
                              self._ws(z, cm), g)
            n = lo["density_points"]
            p0 = torch.rand((b, n, 3), generator=g, device=g.device) * 2 - 1
            p1 = p0 + torch.randn((b, n, 3), generator=g, device=g.device) \
                * lo["density_reg_p_dist"]
            _, sigma = eg3d.decoder(self.G["decoder"], e["render"],
                                    eg3d.sample_planes(
                                        planes, torch.cat([p0, p1], 1),
                                        e["render"]["box_warp"]))
            loss = F.l1_loss(sigma[:, :n], sigma[:, n:]) * lo["density_reg"]
            terms = {"Greg": loss}
        elif name == "Dmain":
            with torch.no_grad():
                z, c, cm = self._draw(g, pool, b)
                img, raw = synthesis(self.G, e, self._ws(z, cm, True), c, g)
            loss_gen = F.softplus(self._d(img, raw, c)).mean()
            loss_real = F.softplus(-self._d(*self._reals(real),
                                            real_c)).mean()
            loss = loss_gen + loss_real
            terms = {"Dgen": loss_gen, "Dreal": loss_real}
        else:
            image, raw = (t.detach().requires_grad_(True)
                          for t in self._reals(real))
            logits = self._d(image, raw, real_c)
            gi, gr = torch.autograd.grad(logits.sum(), [image, raw],
                                         create_graph=True)
            r1 = (gi.square().sum((1, 2, 3)) + gr.square().sum((1, 2, 3))) \
                * (lo["r1_gamma"] / 2)
            loss = (logits[:, 0] * 0 + r1).mean()
            terms = {"Dr1": r1.mean()}
        leaves = self.g_leaves if name.startswith("G") else self.d_leaves
        grads = torch.autograd.grad(loss * gain, leaves, allow_unused=True)
        return {k: v.detach() for k, v in terms.items()}, grads

    def step(self, real, real_c, pool, g):
        """One step → (loss_Gmain, loss_Dgen + loss_Dreal, the latest
        Greg's loss); every phase's terms kept in `terms`."""
        sched, k = self.config["schedule"], self.count
        self.terms = {}
        for name in (p for p in PHASES if k % sched[p] == 0):
            terms, grads = self.phase(name, real, real_c, pool, g)
            (self.adam_g if name.startswith("G") else self.adam_d).step(grads)
            if self.g_first is None and name == "Gmain":
                self.g_first = [None if m is None else m.clone()
                                for m in self.adam_g.m]
            self.terms.update(terms)
        self.greg = self.terms.get("Greg", self.greg)
        lo = self.config["loss"]
        beta = 0.5 ** (self.config["batch_global"] / (lo["ema_kimg"] * 1000))
        with torch.no_grad():
            for (p, t), (_, te) in zip(_flat(self.G), _flat(self.G_ema)):
                te.copy_(t if is_buffer(p) else t.lerp(te, beta))
        self.count += 1
        return torch.stack((self.terms["Gmain"],
                            self.terms["Dgen"] + self.terms["Dreal"],
                            self.greg))

    def first_grads(self, named: list) -> list:
        """G's first moments after its first phase (Gmain at step 0), D's
        after step 0 (R1's, with β1 = 0), by the leaves' identity; zeros
        where none."""
        moments = {id(t): m for t, m in zip(self.g_leaves + self.d_leaves,
                                           self.g_first + self.adam_d.m)}
        return [moments.get(id(t)) if moments.get(id(t)) is not None
                else torch.zeros_like(t) for t in named]


def _clone(tree: dict) -> dict:
    return {k: _clone(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}
