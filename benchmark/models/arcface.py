"""ArcFace face-recognition training for the benchmark: an iresnet trunk
under PartialFC's margin softmax, trained by SGD with the class table's
rows sampled each step.

The adapter of a configuration dict whose "model" is "arcface", to the
contract in `harness.py`:

  * `spec(config)`: the trunk's parameters ("backbone/…") and BatchNorm's
    running moments ("batch_stats/…") in the port's `ParamTree` layout,
    then the (classes, d) table of class centres ("fc_weight"): kaiming
    normal convolutions (fan out), PReLU at 0.25, the trunk's FC and the
    table N(0, 0.01²), BatchNorm's scale 1 and shift 0;
  * `inputs(config, traffic, seed, device)`: a pool of aligned crops
    uniform in [-1, 1] (NHWC) and labels uniform over every class, on the
    device, and the run's seed on the host, a copy a row;
  * `program(config)`: `train.arcface.make_train_step`, the step that
    `cli/train_arcface.py` runs, on an `ArcFaceState` built from the
    tree; `reference(config)`, `control(config)`: the plain reference
    (`reference/arcface.py`) with TF32 off, and on (the control);
  * `flops`, `kernel_counters` (K5/K6, the flash-CE kernels) and
    `ALTERED_LEAF` (the trunk's FC weight).

Step k of a trainer draws its classes from a generator seeded from (the
run's seed, k), the program's and the reference's alike, so that both
sample the same rows. The port is imported inside the program only.
"""

from __future__ import annotations

import math

import torch

from ..counts import flash_ce as ce_counts
from ..counts import iresnet as iresnet_counts
from ..reference import arcface as ref
from ..weights import generator, leaves
from .hfagp import tf32

INPUTS_STREAM = 3
SAMPLE_STREAM = 16          # step k draws on stream SAMPLE_STREAM + k
ALTERED_LEAF = "backbone/fc/weight"


# -- weights and inputs ------------------------------------------------------------


def spec(config: dict):
    net = config["network"]
    params, stats = [], []

    def conv(path, cin, cout, k):
        params.append((f"backbone/{path}", (cout, cin, k, k), "normal",
                       math.sqrt(2.0 / (k * k * cout))))

    def bn(path, c):
        params.extend([(f"backbone/{path}/scale", (c,), "ones", None),
                       (f"backbone/{path}/bias", (c,), "zeros", None)])
        stats.extend([(f"batch_stats/{path}/mean", (c,), "zeros", None),
                      (f"batch_stats/{path}/var", (c,), "ones", None)])

    def prelu(path, c):
        params.append((f"backbone/{path}/alpha", (c,), "fill", 0.25))

    chans = iresnet_counts.CHANNELS
    conv("stem_conv", 3, chans[0], 3)
    bn("stem_bn", chans[0])
    prelu("stem_prelu", chans[0])
    cin = chans[0]
    for stage, (n, cout) in enumerate(zip(
            iresnet_counts.LAYERS[net["name"]], chans)):
        for i in range(n):
            b = f"s{stage}_b{i}"
            bn(f"{b}/bn1", cin)
            conv(f"{b}/conv1", cin, cout, 3)
            bn(f"{b}/bn2", cout)
            prelu(f"{b}/prelu", cout)
            conv(f"{b}/conv2", cout, cout, 3)
            bn(f"{b}/bn3", cout)
            if i == 0:
                conv(f"{b}/down_conv", cin, cout, 1)
                bn(f"{b}/down_bn", cout)
            cin = cout
    d, feat = net["embedding_size"], net["input_size"] // 16
    bn("bn2", cin)
    params.extend([("backbone/fc/weight", (d, cin * feat * feat), "normal",
                    0.01),
                   ("backbone/fc/bias", (d,), "zeros", None)])
    bn("features_bn", d)
    table = ("fc_weight", (config["head"]["num_classes"], d), "normal", 0.01)
    return params + stats + [table]


def inputs(config: dict, traffic: dict, seed: int, device) -> dict:
    """{"image": (P, size, size, 3) in [-1, 1], "label": (P,) int64 over
    every class} on the device, and "seed": (P,) the run's seed on the
    host, from which a trainer seeds its sampling."""
    g = generator(seed, INPUTS_STREAM, device)
    n, s = traffic["pool"], config["network"]["input_size"]
    return {"image": torch.rand((n, s, s, 3), generator=g,
                                device=device) * 2 - 1,
            "label": torch.randint(config["head"]["num_classes"], (n,),
                                   generator=g, device=device),
            "seed": torch.full((n,), seed, dtype=torch.int64)}


def sample_seed(seed: int, k: int) -> int:
    """The seed of step k's class draw."""
    return generator(seed, SAMPLE_STREAM + k, "cpu").initial_seed()


# -- the port ----------------------------------------------------------------------------


def _check_constants(net: dict):
    from hfa_gp_tpu_torch.models.arcface import iresnet, norm
    if (net["bn_eps"], net["bn_momentum"]) != (iresnet._BN_EPS,
                                               norm.BN_MOMENTUM):
        raise ValueError("the port's iresnet fixes BatchNorm's eps at "
                         f"{iresnet._BN_EPS} and momentum at "
                         f"{norm.BN_MOMENTUM}")


class Program:
    """`train.arcface.make_train_step`, looked up at each trainer's build
    (so a test can plant a fault under it)."""

    def __init__(self, config: dict):
        self.config = config

    def trainer(self, tree, aux_tree, paths):
        assert aux_tree is None
        return PortTrainer(self.config, tree, paths)


class PortTrainer:
    def __init__(self, config: dict, tree, paths):
        from hfa_gp_tpu_torch.parallel.partial_fc import PartialFC
        from hfa_gp_tpu_torch.train import arcface as arc
        from hfa_gp_tpu_torch.utils.convert import ParamTree
        net, head, t = config["network"], config["head"], config["train"]
        _check_constants(net)
        m1, m2, m3 = head["margin_list"]
        pfc = PartialFC(head["num_classes"], net["embedding_size"],
                        s=head["s"], m1=m1, m2=m2, m3=m3,
                        sample_rate=head["sample_rate"], matmul_dtype=None)
        tx, fc_tx = arc.make_optimizers(
            t["total_steps"], lr=t["lr"], warmup_steps=t["warmup_steps"],
            momentum=t["momentum"], weight_decay=t["weight_decay"],
            optimizer=t["optimizer"], clip_grad_norm=t["clip_grad_norm"])
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

    def step(self, batch):
        self.gen.manual_seed(sample_seed(int(batch["seed"][0]), self.k))
        self.k += 1
        return self.step_fn(self.state, batch["image"], batch["label"],
                            self.gen)["loss"]

    def first_grads(self):
        """The first step's gradients as SGD got them, from its momentum
        after one step (the clipped gradient plus the weight decay): the
        backbone's buffers and the table's "mom"; zero for the running
        moments, which no gradient reaches."""
        st = self.state.optimizer.state
        return [self.state.fc_opt_state["mom"] if path == "fc_weight"
                else st[p]["momentum_buffer"] if p in st
                else torch.zeros_like(p)
                for path, p in zip(self.paths, self.leaves)]


# -- the reference and its control --------------------------------------------------------


class Reference:
    """The plain reference, with TF32 on (`lower=True`, the control) or
    off. It takes the weights and inputs the benchmark made. On a device
    without TF32 the control rounds every convolution's and product's
    operands to TF32 itself."""

    def __init__(self, config: dict, lower: bool = False):
        self.config, self.lower = config, lower

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
                            ref.round_tf32 if reference.lower
                            and device.type != "cuda" else None)
        self.gen = torch.Generator(device)

    def step(self, batch):
        head = self.reference.config["head"]
        self.gen.manual_seed(sample_seed(int(batch["seed"][0]),
                                         self.run.count))
        draw = torch.rand((head["num_classes"],), generator=self.gen,
                          device=self.gen.device)
        with tf32(self.reference.lower):
            return self.run(batch["image"], batch["label"], draw)

    def first_grads(self):
        """As the program's: the momentum, read after the first step."""
        mom = iter(self.run.momentum)
        return [self.run.table_momentum if p == "fc_weight"
                else next(mom) if p.startswith("backbone/")
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
    """FLOPs of a training step: the trunk's forward and the cosines over
    the sampled rows, three times (the forward, a backward of twice it)."""
    net, head = config["network"], config["head"]
    k = ce_counts.sampled(head["num_classes"], head["sample_rate"], b)
    return 3 * (iresnet_counts.forward(net, b)
                + ce_counts.products(b, k, net["embedding_size"]))


def kernel_counters():
    """The port's launch counters: {kernel: (forward, backward)}."""
    from hfa_gp_tpu_torch.core.kernels import flash_ce
    return {"flash_ce": (flash_ce.LAUNCHES, flash_ce.LAUNCHES_BWD)}
