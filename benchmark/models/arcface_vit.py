"""ArcFace face-recognition training with a ViT trunk for the benchmark:
arcface_torch's ViT recipe, PartialFC's margin softmax over the sampled
rows of the class table, AdamW on the trunk and on the sampled rows.

The adapter of a configuration dict whose "model" is "arcface_vit", to the
contract in `harness.py`:

  * `spec(config)`: the trunk's parameters ("backbone/…") and the head's
    BatchNorm1d running moments ("batch_stats/…") in the port's
    `ParamTree` layout (`models/arcface/vit.init_vit`), then the
    (classes, d) table of class centres ("fc_weight"): every weight, the
    positions and the mask token N(0, 0.02²), biases 0, the norms' scales
    1, the table N(0, 0.01²);
  * `inputs`: arcface's (`models/arcface.inputs`), crops and labels on the
    device and the run's seed on the host;
  * `program(config)`: `train.arcface.make_train_step` with AdamW, the
    step that `cli/train_arcface.py --optimizer adamw` runs, on an
    `ArcFaceState` built from the tree; `reference(config)`,
    `control(config)`: the plain reference (`reference/vit.py`) with TF32
    off, and on (the control);
  * `flops`, `kernel_counters` (K5/K6) and `ALTERED_LEAF` (the head's
    first Linear).

Step k of a trainer seeds its generator from (the run's seed, k), the
program's and the reference's alike (`arcface.sample_seed`); the masking,
the drop path and the class draw all come from it, in that order. The
port is imported inside the program only.
"""

from __future__ import annotations

import torch

from ..counts import flash_ce as ce_counts
from ..counts import vit as vit_counts
from ..reference import arcface as ref_arcface
from ..reference import vit as ref
from ..weights import leaves
from . import arcface
from .hfagp import tf32

ALTERED_LEAF = "backbone/head0/weight"
STD = 0.02                  # every weight of the trunk
inputs = arcface.inputs
kernel_counters = arcface.kernel_counters


# -- weights ---------------------------------------------------------------------------


def spec(config: dict):
    net = config["network"]
    dim, d = net["dim"], net["embedding_size"]
    hidden = int(dim * net["mlp_ratio"])
    n = vit_counts.tokens(net)
    params, stats = [], []

    def linear(path, cin, cout, bias=True):
        params.append((f"backbone/{path}/weight", (cout, cin), "normal", STD))
        if bias:
            params.append((f"backbone/{path}/bias", (cout,), "zeros", None))

    def ln(path, c):
        params.extend([(f"backbone/{path}/scale", (c,), "ones", None),
                       (f"backbone/{path}/bias", (c,), "zeros", None)])

    def bn(path, c):
        ln(path, c)
        stats.extend([(f"batch_stats/{path}/mean", (c,), "zeros", None),
                      (f"batch_stats/{path}/var", (c,), "ones", None)])

    linear("patch_embed", net["patch"] ** 2 * 3, dim)
    params.extend([("backbone/pos_embed", (n, dim), "normal", STD),
                   ("backbone/mask_token", (dim,), "normal", STD)])
    for i in range(net["depth"]):
        ln(f"blk{i}/ln1", dim)
        linear(f"blk{i}/qkv", dim, 3 * dim, bias=False)
        linear(f"blk{i}/proj", dim, dim)
        ln(f"blk{i}/ln2", dim)
        linear(f"blk{i}/fc1", dim, hidden)
        linear(f"blk{i}/fc2", hidden, dim)
    ln("norm", dim)
    linear("head0", n * dim, dim, bias=False)
    bn("head0_bn", dim)
    linear("head1", dim, d, bias=False)
    bn("head1_bn", d)
    table = ("fc_weight", (config["head"]["num_classes"], d), "normal", 0.01)
    return params + stats + [table]


# -- the port ----------------------------------------------------------------------------


def _check_constants(config: dict):
    """The configuration's fixed numbers against the port's: the trunk's
    shape and rates, its norms' eps, and the rows' AdamW betas and eps
    (the trunk's `torch.optim.AdamW` is built with the same)."""
    from hfa_gp_tpu_torch.models.arcface import norm, vit
    from hfa_gp_tpu_torch.train import arcface as arc
    net, t = config["network"], config["train"]
    keys = ("patch", "dim", "depth", "heads", "mlp_ratio", "drop_path_rate",
            "mask_ratio")
    want = {"shape": tuple(net[k] for k in keys),
            "crop": net["crop"], "ln_eps": net["ln_eps"],
            "bn_eps": net["bn_eps"], "bn_momentum": net["bn_momentum"],
            "adamw": (*t["betas"], t["eps"])}
    fc = arc.FCOptimizer
    port = {"shape": vit.VIT_CONFIGS[net["name"]],
            "crop": vit.INPUT_SIZE, "ln_eps": vit._LN_EPS,
            "bn_eps": vit._BN_EPS, "bn_momentum": norm.BN_MOMENTUM,
            "adamw": (fc.b1, fc.b2, fc.eps)}
    if want != port:
        raise ValueError(f"the configuration states {want}; the port fixes "
                         f"{port}")


class Program(arcface.Program):
    def trainer(self, tree, aux_tree, paths):
        assert aux_tree is None
        return PortTrainer(self.config, tree, paths)


class PortTrainer(arcface.PortTrainer):
    """arcface's trainer (its `step`) on a ViT under AdamW."""

    def __init__(self, config: dict, tree, paths):
        from hfa_gp_tpu_torch.parallel.partial_fc import PartialFC
        from hfa_gp_tpu_torch.train import arcface as arc
        from hfa_gp_tpu_torch.utils.convert import ParamTree
        net, head, t = config["network"], config["head"], config["train"]
        _check_constants(config)
        m1, m2, m3 = head["margin_list"]
        pfc = PartialFC(head["num_classes"], net["embedding_size"],
                        s=head["s"], m1=m1, m2=m2, m3=m3,
                        sample_rate=head["sample_rate"], matmul_dtype=None)
        tx, fc_tx = arc.make_optimizers(
            t["total_steps"], lr=t["lr"], warmup_steps=t["warmup_steps"],
            weight_decay=t["weight_decay"], optimizer=t["optimizer"],
            clip_grad_norm=t["clip_grad_norm"])
        backbone = ParamTree(tree["backbone"]).requires_grad_(True)
        stats = ParamTree(tree["batch_stats"])
        table = tree["fc_weight"]
        self.state = arc.ArcFaceState(
            backbone=backbone, batch_stats=stats, fc_weight=table,
            optimizer=tx.build(backbone), fc_opt_state=fc_tx.init(table))
        self.step_fn = arc.make_train_step(pfc, tx, fc_tx, net["name"],
                                           dtype=torch.float32)
        named = {"fc_weight": table}
        for prefix, module in (("backbone", backbone), ("batch_stats", stats)):
            named.update({f"{prefix}/{k.replace('.', '/')}": v
                          for k, v in module.named_parameters()})
        self.paths, self.leaves = paths, [named[p] for p in paths]
        self.gen = torch.Generator(table.device)
        self.k = 0

    def first_grads(self):
        """The first step's gradients as AdamW got them, from its first
        moment after one step ((1 − β1) × the clipped gradient): the
        backbone's `exp_avg` and the table's "m"; zero for the running
        moments, which no gradient reaches."""
        st = self.state.optimizer.state
        return [self.state.fc_opt_state["m"] if path == "fc_weight"
                else st[p]["exp_avg"] if p in st
                else torch.zeros_like(p)
                for path, p in zip(self.paths, self.leaves)]


# -- the reference and its control --------------------------------------------------------


class Reference(arcface.Reference):
    def trainer(self, tree, aux_tree, paths):
        return RefTrainer(self, tree, paths)


class RefTrainer:
    def __init__(self, reference: Reference, tree, paths):
        self.reference, self.paths = reference, paths
        flat = dict(leaves(tree))
        self.leaves = [flat[p] for p in paths]
        trained = [flat[p].requires_grad_(True) for p in paths
                   if p.startswith("backbone/")]
        device = tree["fc_weight"].device
        self.run = ref.Step(reference.config, tree, trained,
                            ref_arcface.round_tf32 if reference.lower
                            and device.type != "cuda" else None)
        self.gen = torch.Generator(device)

    def step(self, batch):
        self.gen.manual_seed(arcface.sample_seed(int(batch["seed"][0]),
                                                 self.run.count))
        with tf32(self.reference.lower):
            return self.run(batch["image"], batch["label"], self.gen)

    def first_grads(self):
        """As the program's: the first moment, read after the first step."""
        m = iter(self.run.m)
        return [self.run.table_m if p == "fc_weight"
                else next(m) if p.startswith("backbone/")
                else torch.zeros_like(t)
                for p, t in zip(self.paths, self.leaves)]


def program(config):
    return Program(config)


def reference(config):
    return Reference(config)


def control(config):
    return Reference(config, lower=True)


# -- counts ------------------------------------------------------------------------------------


def flops(config: dict, entry: str, b: int) -> int:
    """FLOPs of a training step: the trunk's forward at the kept tokens and
    the cosines over the sampled rows, three times (the forward, a
    backward of twice it)."""
    net, head = config["network"], config["head"]
    k = ce_counts.sampled(head["num_classes"], head["sample_rate"], b)
    return 3 * (vit_counts.forward(net, b, train=entry == "fit")
                + ce_counts.products(b, k, net["embedding_size"]))
