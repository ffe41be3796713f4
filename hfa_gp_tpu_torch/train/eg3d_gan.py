"""EG3D's GAN training (NVlabs/eg3d `training/training_loop.py` with
`training/loss.py`'s `StyleGAN2Loss`, as the FFHQ 512 recipe sets them):
the tri-plane generator G against the pose-conditioned dual
discriminator D (`models/eg3d/discriminator.py`), with lazy R1 and
density regularisation.

A step runs up to four phases, in this order, each when the step's index
k is a multiple of its interval (so step 0 runs all four):

  Gmain (1)   softplus(−D(G(z, c'), c)), G's Adam
  Greg  (4)   0.25 · |σ(p) − σ(p + 0.004·n)|₁ over 1,000 points a sample
              of the box, times 4, G's Adam
  Dmain (1)   softplus(D(G(z, c'), c)) + softplus(−D(real, c_real)), D's
              Adam; G runs without gradient and tracks w_avg
  Dreg  (16)  (γ/2)·(‖∂D/∂image‖² + ‖∂D/∂image_raw‖²) on the reals, times
              16, D's Adam: the gradient of an input gradient, through
              K9 at second order on the card

then G_ema ← lerp(G, G_ema, 0.5^(32/10,000)). c is a label drawn from the
pool of the data's labels, c' the generator's conditioning: c, or with
probability `gpc_reg_prob` the batch's previous row's c (row by row; in
Greg for the whole batch at once, as EG3D draws it). Each phase zeroes
the gradients, makes its own network alone trainable, runs its loss ×
its interval backward, replaces NaN and infinite gradients and steps its
Adam, which steps only the parameters that got a gradient. Under lazy
regularisation each Adam's lr is ×ratio and its betas ^ratio (ratio 4/5
for G, 16/17 for D).

Every draw of a step comes from the one generator the caller seeds for
it, in this order: a phase's z, the label indices, the swaps, the
backbone's noise, then the render's jitter (Gmain, Dmain) or the density
points (Greg). G's `mapping.w_avg` and `noise_const` are buffers: never
trained, copied into G_ema.

Spans (`utils.observability.annotate`): "train_step" ▸ "Gmain", "Greg",
"Dmain", "Dreg" ▸ "forward", "backward", "optimizer"; then "ema". Every
forward of D runs inside a "discriminator" span; the generator keeps its
"backbone", "render" and "superres" spans.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from ..models.eg3d import discriminator as disc
from ..models.eg3d import generator as gen
from ..utils.observability import annotate

PHASES = ("Gmain", "Greg", "Dmain", "Dreg")


@dataclass(frozen=True)
class GANConfig:
    """The training recipe; the numbers are EG3D's FFHQ defaults."""
    generator: gen.EG3DConfig = field(default_factory=gen.EG3DConfig)
    discriminator: disc.DiscriminatorConfig = field(
        default_factory=disc.DiscriminatorConfig)
    g_lr: float = 0.0025
    d_lr: float = 0.002
    betas: tuple[float, float] = (0.0, 0.99)
    eps: float = 1e-8
    g_reg_interval: int = 4
    d_reg_interval: int = 16
    r1_gamma: float = 1.0
    gpc_reg_prob: float = 0.5
    density_reg: float = 0.25
    density_reg_p_dist: float = 0.004
    density_points: int = 1000
    ema_kimg: float = 10.0
    ema_batch: int = 32               # the whole job's images a step
    w_avg_beta: float = 0.995

    def interval(self, phase: str) -> int:
        return {"Gmain": 1, "Greg": self.g_reg_interval, "Dmain": 1,
                "Dreg": self.d_reg_interval}[phase]

    @property
    def ema_beta(self) -> float:
        return 0.5 ** (self.ema_batch / (self.ema_kimg * 1000))


@dataclass
class GANState:
    G: nn.Module                    # `utils.convert.ParamTree`s
    D: nn.Module
    G_ema: nn.Module
    opt_G: torch.optim.Optimizer
    opt_D: torch.optim.Optimizer
    step: int = 0


def is_buffer(name: str) -> bool:
    """Whether a leaf of G (dotted name) is a buffer, never trained."""
    return name.endswith("w_avg") or name.endswith("noise_const")


def trainable(tree: nn.Module) -> list[torch.Tensor]:
    return [p for n, p in tree.named_parameters() if not is_buffer(n)]


def lazy_adam(params, lr: float, betas, eps: float,
              interval: int) -> torch.optim.Adam:
    """Adam with lazy regularisation's ratio interval / (interval + 1)."""
    r = interval / (interval + 1)
    return torch.optim.Adam(params, lr=lr * r,
                            betas=(betas[0] ** r, betas[1] ** r), eps=eps)


def init_state(G: nn.Module, D: nn.Module, cfg: GANConfig) -> GANState:
    """A state on G's and D's devices: their trained leaves need a
    gradient, the buffers and G_ema, a copy of G, none."""
    G_ema = copy.deepcopy(G).requires_grad_(False)
    for tree in (G, D):
        for n, p in tree.named_parameters():
            p.requires_grad_(not is_buffer(n))
    return GANState(
        G=G, D=D, G_ema=G_ema,
        opt_G=lazy_adam(trainable(G), cfg.g_lr, cfg.betas, cfg.eps,
                        cfg.g_reg_interval),
        opt_D=lazy_adam(trainable(D), cfg.d_lr, cfg.betas, cfg.eps,
                        cfg.d_reg_interval))


def init_networks(g: torch.Generator, cfg: GANConfig) -> tuple[dict, dict]:
    """G's and D's random parameters from `g` as EG3D initialises them
    (nested dicts of CPU tensors): weights N(0, 1), biases 0, and the
    layers of both mappings at their lr_mul N(0, 1/lr_mul²), so that the
    weight gain lr_mul/√fan_in gives them unit variance."""
    G = gen.init_generator(g, cfg.generator)
    lr_mul = cfg.generator.mapping.lr_multiplier
    for name, layer in G["mapping"].items():
        if name.startswith("fc"):
            layer["weight"] /= lr_mul
    return G, disc.init_discriminator(g, cfg.discriminator)


def phases_at(step: int, cfg: GANConfig) -> list[str]:
    return [p for p in PHASES if step % cfg.interval(p) == 0]


# -- the networks as the phases call them ----------------------------------------


def draw_conditioning(g: torch.Generator, pool: torch.Tensor, b: int,
                      z_dim: int, swap_prob: float, *, per_row: bool = True):
    """(z (b, z_dim), c (b, 25) drawn from the label pool, c' the
    generator's conditioning) from g, in that order. The swap is drawn
    row by row, or once for the whole batch where not `per_row`, as
    EG3D's loss draws it in Greg."""
    dev = g.device
    z = torch.randn((b, z_dim), generator=g, device=dev)
    idx = torch.randint(pool.shape[0], (b,), generator=g, device=dev)
    c = pool[idx.to(pool.device)]
    swap = torch.rand((b, 1) if per_row else (), generator=g,
                      device=dev) < swap_prob
    return z, c, torch.where(swap.to(c.device), c.roll(1, 0), c)


def run_G(G, cfg: GANConfig, z, c, c_map, g: torch.Generator, *,
          update_emas: bool = False) -> dict:
    """The generator's image and raw image, NCHW, with random noise and
    jittered depths from g."""
    ec = cfg.generator
    ws = gen.mapping(G, ec, z, c_map, update_emas=update_emas,
                     w_avg_beta=cfg.w_avg_beta)
    out = gen.synthesis(G, ec, ws, c, noise_mode="random",
                        render_generator=g, noise_generator=g)
    return {"image": out["image"].permute(0, 3, 1, 2),
            "image_raw": out["image_raw"].permute(0, 3, 1, 2)}


def run_D(D, cfg: GANConfig, image, image_raw, c) -> torch.Tensor:
    with annotate("discriminator"):
        return disc.discriminator_apply(D, cfg.discriminator, image,
                                        image_raw, c)


def real_images(real_image: torch.Tensor, cfg: GANConfig):
    """Channel-last reals (B, H, W, 3) → (image, image_raw) NCHW, the raw
    one at the neural rendering resolution by antialiased bilinear."""
    image = real_image.permute(0, 3, 1, 2)
    res = cfg.generator.render.neural_rendering_resolution
    return image, disc.resize_raw(image, res)


# -- the phases --------------------------------------------------------------------


def _gmain(state, cfg, real, real_c, pool, g):
    b = real.shape[0]
    z, c, c_map = draw_conditioning(g, pool, b, cfg.generator.mapping.z_dim,
                                    cfg.gpc_reg_prob)
    fake = run_G(state.G, cfg, z, c, c_map, g)
    logits = run_D(state.D, cfg, fake["image"], fake["image_raw"], c)
    loss = F.softplus(-logits).mean()
    return loss, {"Gmain": loss}


def _greg(state, cfg, real, real_c, pool, g):
    b = real.shape[0]
    ec = cfg.generator
    z, _, c_map = draw_conditioning(g, pool, b, ec.mapping.z_dim,
                                    cfg.gpc_reg_prob, per_row=False)
    ws = gen.mapping(state.G, ec, z, c_map)
    planes = gen.planes(state.G, ec, ws, noise_mode="random",
                        noise_generator=g)
    n = cfg.density_points
    p0 = torch.rand((b, n, 3), generator=g, device=g.device) * 2 - 1
    p1 = p0 + torch.randn((b, n, 3), generator=g, device=g.device) \
        * cfg.density_reg_p_dist
    sigma = gen.sample_mixed(state.G, ec, planes,
                             torch.cat([p0, p1], dim=1).to(planes.device))
    loss = F.l1_loss(sigma[:, :n], sigma[:, n:]) * cfg.density_reg
    return loss, {"Greg": loss}


def _dmain(state, cfg, real, real_c, pool, g):
    b = real.shape[0]
    with torch.no_grad():
        z, c, c_map = draw_conditioning(g, pool, b,
                                        cfg.generator.mapping.z_dim,
                                        cfg.gpc_reg_prob)
        fake = run_G(state.G, cfg, z, c, c_map, g, update_emas=True)
    gen_logits = run_D(state.D, cfg, fake["image"], fake["image_raw"], c)
    loss_gen = F.softplus(gen_logits).mean()
    image, image_raw = real_images(real, cfg)
    real_logits = run_D(state.D, cfg, image, image_raw, real_c)
    loss_real = F.softplus(-real_logits).mean()
    return loss_gen + loss_real, {"Dgen": loss_gen, "Dreal": loss_real}


def _dreg(state, cfg, real, real_c, pool, g):
    image, image_raw = real_images(real, cfg)
    image = image.detach().requires_grad_(True)
    image_raw = image_raw.detach().requires_grad_(True)
    logits = run_D(state.D, cfg, image, image_raw, real_c)
    g_img, g_raw = torch.autograd.grad(logits.sum(), [image, image_raw],
                                       create_graph=True)
    penalty = g_img.square().sum((1, 2, 3)) + g_raw.square().sum((1, 2, 3))
    loss_r1 = penalty * (cfg.r1_gamma / 2)
    loss = (logits[:, 0] * 0 + loss_r1).mean()
    return loss, {"Dr1": loss_r1.mean()}


def _nan_to_num(params) -> None:
    for p in params:
        if p.grad is not None:
            torch.nan_to_num(p.grad, nan=0.0, posinf=1e5, neginf=-1e5,
                             out=p.grad)


LOSSES = {"Gmain": _gmain, "Greg": _greg, "Dmain": _dmain, "Dreg": _dreg}


def run_phase(state: GANState, cfg: GANConfig, phase: str,
              real_image: torch.Tensor, real_label: torch.Tensor,
              label_pool: torch.Tensor, generator: torch.Generator) -> dict:
    """One phase: its network alone trainable (the other's leaves need no
    gradient until it ends), its loss × interval backward, its Adam; the
    gradients stay on the leaves until the next phase. → its loss terms."""
    on_g = phase.startswith("G")
    net, opt = (state.G, state.opt_G) if on_g else (state.D, state.opt_D)
    frozen = trainable(state.D if on_g else state.G)
    with annotate(phase):
        opt.zero_grad(set_to_none=True)
        for p in frozen:
            p.requires_grad_(False)
        try:
            with annotate("forward"):
                loss, terms = LOSSES[phase](state, cfg, real_image,
                                            real_label, label_pool, generator)
            with annotate("backward"):
                (loss * cfg.interval(phase)).backward()
        finally:
            for p in frozen:
                p.requires_grad_(True)
        with annotate("optimizer"):
            _nan_to_num(trainable(net))
            opt.step()
    return terms


def update_ema(state: GANState, cfg: GANConfig) -> None:
    """G_ema ← lerp(G, G_ema, β) for the trained leaves; buffers copied."""
    with annotate("ema"), torch.no_grad():
        pairs = list(zip(state.G_ema.named_parameters(),
                         state.G.parameters()))
        ema = [e for (n, e), _ in pairs if not is_buffer(n)]
        cur = [p for (n, _), p in pairs if not is_buffer(n)]
        torch._foreach_lerp_(ema, cur, 1.0 - cfg.ema_beta)
        for (n, e), p in pairs:
            if is_buffer(n):
                e.copy_(p)


def train_step(state: GANState, cfg: GANConfig, real_image: torch.Tensor,
               real_label: torch.Tensor, label_pool: torch.Tensor,
               generator: torch.Generator) -> dict[str, torch.Tensor]:
    """One step in place on `state`: real_image (B, H, W, 3) in [-1, 1]
    channel-last, real_label (B, 25), label_pool (P, 25) the labels that
    the generator's conditioning is drawn from, `generator` seeded for
    this step. Returns each loss term run, detached, as 0-d tensors
    (no host sync here)."""
    terms: dict = {}
    with annotate("train_step"):
        for phase in phases_at(state.step, cfg):
            t = run_phase(state, cfg, phase, real_image, real_label,
                          label_pool, generator)
            terms.update({k: v.detach() for k, v in t.items()})
        update_ema(state, cfg)
        state.step += 1
    return terms
