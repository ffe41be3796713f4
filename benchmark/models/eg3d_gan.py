"""EG3D's FFHQ 512 GAN training for the benchmark: the tri-plane generator
against the dual discriminator, R1 every 16 steps, density
regularisation every 4, two Adams and the generator's EMA.

The adapter of a configuration dict whose "model" is "eg3d_gan", to the
contract in `harness.py`:

  * `spec(config)`: G's parameters ("G/…", the port's EG3D param-tree
    layout, as the avatars draw them, the mappings' layers N(0, 1/lr_mul²)
    as EG3D and the port's `train.eg3d_gan.init_networks` init them) then
    D's ("D/…", NVIDIA's state-dict names:
    `b512.fromrgb`, `b4.fc`, `mapping.fc7`, …);
  * `inputs`: a pool of real 512² images uniform in [-1, 1] with camera
    labels around the frontal pose (`inputs.labels`), the whole pool's
    labels again with every row (the generator's conditioning is drawn
    from them), and the run's seed on the host;
  * `program(config)`: `train.eg3d_gan.train_step`, the step that
    `cli/train_eg3d.py` runs, on a `GANState` built from the tree;
    `reference(config)`, `control(config)`: the plain reference
    (`reference/eg3d_gan.py`) with TF32 off, and on (the control);
  * `flops`: the mean step of the 16-step period; `kernel_counters`: K1/K2
    and K4/K4′ as the avatars'; `ALTERED_LEAF`: D's fc.

A trainer's `step` returns (Gmain's loss, Dmain's fake + real loss, the
latest Greg's loss: step 0's in the first steps), so the check holds the
density term by its loss; `first_grads` reads both Adams' first moments,
which with β1 = 0 hold a phase's gradient: D's after step 0 (R1's), G's
right after its first phase (Gmain's). G's moment after step 0 would
hold the density term's gradient, an l1 of σ at point pairs 0.004 apart:
its sign flips where the pair's σ differ by round-off, and the chip's
sound runs read it 1–60 % apart from the reference's, as far as TF32
does (`PERF.md` §6). Step k seeds one generator from (the run's seed, k),
the program's and the reference's alike (`sample_seed`). The port is
imported inside the program only.
"""

from __future__ import annotations

import torch

from ..counts import discriminator as d_counts
from ..counts import eg3d as eg3d_counts
from ..inputs import INPUTS_STREAM, labels
from ..reference import eg3d_gan as ref
from ..weights import generator, leaves
from .hfagp import _generator_spec, tf32

ALTERED_LEAF = "D/b4/fc/weight"
SAMPLE_STREAM = 16          # step k draws on stream SAMPLE_STREAM + k


# -- weights ---------------------------------------------------------------------


def _discriminator_spec(d: dict):
    out = []

    def conv(path, cin, cout, k, bias=True):
        out.append((f"D/{path}/weight", (cout, cin, k, k), "randn", None))
        if bias:
            out.append((f"D/{path}/bias", (cout,), "zeros", None))

    def fc(path, cin, cout, lr_mul=1.0):
        out.extend([(f"D/{path}/weight", (cout, cin), "normal", 1.0 / lr_mul),
                    (f"D/{path}/bias", (cout,), "zeros", None)])

    top = d["img_resolution"]
    for res in [2 ** i for i in range(top.bit_length() - 1, 2, -1)]:
        c, c2 = d_counts.channels(d, res), d_counts.channels(d, res // 2)
        if res == top:
            conv(f"b{res}/fromrgb", 2 * d["img_channels"], c, 1)
        conv(f"b{res}/conv0", c, c, 3)
        conv(f"b{res}/conv1", c, c2, 3)
        conv(f"b{res}/skip", c, c2, 1, bias=False)
    c = d_counts.channels(d, 4)
    conv("b4/conv", c + d["mbstd_num_channels"], c, 3)
    fc("b4/fc", c * 16, c)
    fc("b4/out", c, c)
    fc("mapping/embed", d["c_dim"], c)
    for i in range(d["mapping_layers"]):
        fc(f"mapping/fc{i}", c, c, d["mapping_lr_multiplier"])
    return out


def spec(config: dict):
    lr_mul = config["eg3d"]["mapping"]["lr_multiplier"]
    g = [(p, s, "normal", 1.0 / lr_mul)
         if p.startswith("G/mapping/fc") and p.endswith("/weight")
         else (p, s, k, a)
         for p, s, k, a in _generator_spec("G", config["eg3d"])]
    return g + _discriminator_spec(config["discriminator"])


def inputs(config: dict, traffic: dict, seed: int, device) -> dict:
    """{"image": (P, R, R, 3) in [-1, 1], "label": (P, 25), "pool_label":
    (P, P, 25) the pool's labels with every row, "seed": (P,) on the
    host}."""
    g = generator(seed, INPUTS_STREAM, device)
    n = traffic["pool"]
    s = config["eg3d"]["sr"]["output_resolution"]
    label = labels(g, n, traffic["pose"], device)
    image = torch.rand((n, s, s, 3), generator=g, device=device) * 2 - 1
    return {"image": image, "label": label,
            "pool_label": label[None].expand(n, -1, -1),
            "seed": torch.full((n,), seed, dtype=torch.int64)}


def sample_seed(seed: int, k: int) -> int:
    """The seed of step k's draws."""
    return generator(seed, SAMPLE_STREAM + k, "cpu").initial_seed()


# -- the port ------------------------------------------------------------------------


def gan_config(config: dict):
    """The port's GANConfig for the configuration dict."""
    from hfa_gp_tpu_torch.models.eg3d import discriminator as disc
    from hfa_gp_tpu_torch.models.eg3d import generator as gen
    from hfa_gp_tpu_torch.models.eg3d import networks, renderer
    from hfa_gp_tpu_torch.train import eg3d_gan
    g, d, lo = config["eg3d"], config["discriminator"], config["loss"]
    opt, sched = config["optimizers"], config["schedule"]
    tup = {"fir", "block_channels"}

    def dc(cls, group, skip=()):
        return cls(**{k: tuple(v) if k in tup else v
                      for k, v in group.items() if k not in skip})

    if (d["disc_c_noise"], d["architecture"], lo["blur_sigma"],
            lo["style_mixing_prob"], lo["reg_type"]) != (0.0, "resnet", 0.0,
                                                         0.0, "l1"):
        raise ValueError("the port trains EG3D without label noise, blur or "
                         "style mixing, with a resnet D and an l1 density "
                         "term")
    if opt["G"]["betas"] != opt["D"]["betas"] \
            or opt["G"]["eps"] != opt["D"]["eps"] \
            or (sched["Gmain"], sched["Dmain"]) != (1, 1):
        raise ValueError("the port's two Adams share betas and eps, and the "
                         "main phases run every step")
    eg3d = gen.EG3DConfig(
        mapping=dc(networks.MappingConfig, g["mapping"]),
        backbone=dc(networks.BackboneConfig, g["backbone"]),
        sr=dc(networks.SRConfig, g["sr"]),
        render=dc(renderer.RenderConfig, g["render"]))
    return eg3d_gan.GANConfig(
        generator=eg3d,
        discriminator=dc(disc.DiscriminatorConfig, d,
                         skip=("disc_c_noise", "architecture")),
        g_lr=opt["G"]["lr"], d_lr=opt["D"]["lr"],
        betas=tuple(opt["G"]["betas"]), eps=opt["G"]["eps"],
        g_reg_interval=sched["Greg"], d_reg_interval=sched["Dreg"],
        r1_gamma=lo["r1_gamma"], gpc_reg_prob=lo["gpc_reg_prob"],
        density_reg=lo["density_reg"],
        density_reg_p_dist=lo["density_reg_p_dist"],
        density_points=lo["density_points"], ema_kimg=lo["ema_kimg"],
        ema_batch=config["batch_global"], w_avg_beta=lo["w_avg_beta"])


class Program:
    def __init__(self, config: dict):
        self.config = config
        self.cfg = gan_config(config)

    def trainer(self, tree, aux_tree, paths):
        assert aux_tree is None
        return PortTrainer(self, tree, paths)


class PortTrainer:
    """`train.eg3d_gan.train_step` on one `GANState`."""

    def __init__(self, program: Program, tree, paths):
        from hfa_gp_tpu_torch.train import eg3d_gan
        from hfa_gp_tpu_torch.utils.convert import ParamTree
        self.program = program
        G, D = ParamTree(tree["G"]), ParamTree(tree["D"])
        self.state = eg3d_gan.init_state(G, D, program.cfg)
        named = {}
        for prefix, module in (("G", G), ("D", D)):
            named.update({f"{prefix}/{k.replace('.', '/')}": v
                          for k, v in module.named_parameters()})
        self.leaves = [named[p] for p in paths]
        self.gen = torch.Generator(tree["D"]["b4"]["fc"]["weight"].device)
        self.g_first = self.greg = None
        self.state.opt_G.register_step_post_hook(self._keep_first)

    def _keep_first(self, opt, args, kwargs):
        """G's first moments after its first phase (Gmain at step 0)."""
        if self.g_first is None:
            self.g_first = {p: s["exp_avg"].clone()
                            for p, s in opt.state.items()}

    def step(self, batch):
        from hfa_gp_tpu_torch.train import eg3d_gan
        self.gen.manual_seed(sample_seed(int(batch["seed"][0]),
                                         self.state.step))
        t = eg3d_gan.train_step(self.state, self.program.cfg, batch["image"],
                                batch["label"], batch["pool_label"][0],
                                self.gen)
        self.greg = t.get("Greg", self.greg)
        return torch.stack((t["Gmain"], t["Dgen"] + t["Dreal"], self.greg))

    def first_grads(self):
        """G's first moments after Gmain, D's after step 0 (with β1 = 0
        the gradients of Gmain and of R1); zero for the buffers and the
        leaves those phases do not reach."""
        st = {**self.g_first, **{p: s["exp_avg"] for p, s in
                                 self.state.opt_D.state.items()}}
        return [st[p] if p in st else torch.zeros_like(p)
                for p in self.leaves]


# -- the reference and its control --------------------------------------------------------


class Reference:
    def __init__(self, config: dict, lower: bool = False):
        self.config, self.lower = config, lower

    def trainer(self, tree, aux_tree, paths):
        return RefTrainer(self, tree, paths)


class RefTrainer:
    def __init__(self, reference: Reference, tree, paths):
        self.reference = reference
        flat = dict(leaves(tree))
        self.leaves = [flat[p] for p in paths]
        self.run = ref.Trainer(reference.config, tree["G"], tree["D"])
        self.gen = torch.Generator(self.leaves[0].device)

    def step(self, batch):
        self.gen.manual_seed(sample_seed(int(batch["seed"][0]),
                                         self.run.count))
        with tf32(self.reference.lower):
            return self.run.step(batch["image"], batch["label"],
                                 batch["pool_label"][0], self.gen)

    def first_grads(self):
        return self.run.first_grads(self.leaves)


def program(config):
    return Program(config)


def reference(config):
    return Reference(config)


def control(config):
    return Reference(config, lower=True)


# -- counts ------------------------------------------------------------------------------------


def phase_flops(config: dict, b: int) -> dict:
    """FLOPs of each phase at b images: a backward costs twice its forward,
    and once where only the inputs' gradients are taken (D in Gmain); R1's
    gradient of the input gradient costs D's forward six times (forward,
    input gradient, its two products' derivatives, and the weights' and
    inputs' gradients through the forward)."""
    g = config["eg3d"]
    syn = eg3d_counts.synthesis(g, b)
    disc = d_counts.forward(config["discriminator"], b)
    return {"Gmain": 3 * syn + 2 * disc,
            "Greg": 3 * eg3d_counts.backbone(g, b),
            "Dmain": syn + 2 * 3 * disc,
            "Dreg": 6 * disc}


def flops(config: dict, entry: str, b: int) -> int:
    """The mean step's FLOPs over a period of the lazy schedule."""
    sched = config["schedule"]
    period = max(sched.values())
    per = phase_flops(config, b)
    return sum(per[p] * (period // sched[p]) for p in per) // period


def kernel_counters():
    """The port's launch counters: {kernel: (forward, backward)}."""
    from hfa_gp_tpu_torch.core.kernels import raymarch, triplane
    return {"sampler": (triplane.LAUNCHES, triplane.LAUNCHES_BWD),
            "marcher": (raymarch.LAUNCHES, raymarch.LAUNCHES_BWD)}
