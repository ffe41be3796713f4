"""A training cell of no model the benchmark ships, for the CPU tests: a
two-layer classifier in plain PyTorch with integer labels, trained by SGD
with momentum, with no second tree. It keeps the adapter contract of
`harness.py`; `install` puts it where the harness finds a model by name,
as `benchmark.models.toy`, for the length of a test.

The program uses `torch.nn.functional` and `torch.optim.SGD`; the
reference writes the products, the activation, the loss and the update
out by hand; the control is that reference with every product's operands
rounded to bf16.
"""

from __future__ import annotations

import math
import sys

import torch
import torch.nn.functional as F

from benchmark import harness, weights

NAME = "toy"
CONFIG = {"model": NAME, "features": 32, "hidden": 64, "classes": 10,
          "train": {"lr": 0.05, "momentum": 0.9}}
TRAFFIC = {"entry": "fit", "batch": 8, "pool": 64, "first_steps": 3}
LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-5}
INPUTS_STREAM = 3
ALTERED_LEAF = "fc1/weight"


def install(monkeypatch):
    """This module as the adapter of "model": "toy"."""
    monkeypatch.setitem(sys.modules, f"benchmark.models.{NAME}",
                        sys.modules[__name__])


def cell(limits: dict = LIMITS) -> dict:
    """The toy cell, with the manifest's own fitting metrics."""
    bench = harness.manifest()
    keep = {"train_steps_per_s", "setup_s", "mfu.fit", "backward_ms.fit"}
    return {"workload": {"name": "toy_fit_b8", "config": NAME,
                         "traffic": "toy_fit_b8", "chips": 1, "why": "tests"},
            "config": CONFIG, "traffic": TRAFFIC, "limits": limits,
            "end_to_end": [m for m in bench["end_to_end"]
                           if m["name"] in keep],
            "per_layer": [m for m in bench["per_layer"] if m["name"] in keep]}


# -- the adapter -------------------------------------------------------------


def spec(config: dict):
    f, h, c = config["features"], config["hidden"], config["classes"]
    return [("fc0/weight", (h, f), "normal", math.sqrt(2.0 / f)),  # kaiming
            ("fc0/bias", (h,), "zeros", None),
            ("act/weight", (h,), "fill", 0.25),                     # PReLU
            ("fc1/weight", (c, h), "normal", 0.01),
            ("fc1/bias", (c,), "zeros", None)]


def inputs(config: dict, traffic: dict, seed: int, device) -> dict:
    g = weights.generator(seed, INPUTS_STREAM, device)
    n = traffic["pool"]
    return {"x": torch.randn((n, config["features"]), generator=g,
                             device=device),
            "label": torch.randint(config["classes"], (n,), generator=g,
                                   device=device)}


def flops(config: dict, entry: str, b: int) -> int:
    f, h, c = config["features"], config["hidden"], config["classes"]
    return 3 * 2 * b * (f * h + h * c)


def kernel_counters():
    return {}


def _leaves(tree, paths):
    flat = dict(weights.leaves(tree))
    return [flat[p].requires_grad_(True) for p in paths]


class Program:
    def __init__(self, config: dict):
        self.config = config

    def trainer(self, tree, aux_tree, paths):
        assert aux_tree is None
        return ProgramTrainer(self.config, tree, paths)


class ProgramTrainer:
    def __init__(self, config, tree, paths):
        self.tree, self.leaves = tree, _leaves(tree, paths)
        t = config["train"]
        self.opt = torch.optim.SGD(self.leaves, lr=t["lr"],
                                   momentum=t["momentum"])

    def step(self, batch):
        t = self.tree
        h = F.prelu(F.linear(batch["x"], t["fc0"]["weight"], t["fc0"]["bias"]),
                    t["act"]["weight"])
        loss = F.cross_entropy(F.linear(h, t["fc1"]["weight"],
                                        t["fc1"]["bias"]), batch["label"])
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def first_grads(self):
        """SGD's momentum after one step: the first gradient itself."""
        return [self.opt.state[p]["momentum_buffer"] for p in self.leaves]


class Reference:
    def __init__(self, config: dict, lower: bool = False):
        self.config, self.lower = config, lower

    def trainer(self, tree, aux_tree, paths):
        return RefTrainer(self, tree, paths)


class RefTrainer:
    def __init__(self, reference, tree, paths):
        self.reference, self.tree = reference, tree
        self.leaves = _leaves(tree, paths)
        self.momentum = [torch.zeros_like(p) for p in self.leaves]
        self.grads = None

    def _mm(self, x, w):
        if self.reference.lower:
            x, w = x.bfloat16().float(), w.bfloat16().float()
        return x @ w.T

    def step(self, batch):
        t, cfg = self.tree, self.reference.config["train"]
        z = self._mm(batch["x"], t["fc0"]["weight"]) + t["fc0"]["bias"]
        h = torch.where(z >= 0, z, t["act"]["weight"] * z)
        logits = self._mm(h, t["fc1"]["weight"]) + t["fc1"]["bias"]
        logp = logits - logits.logsumexp(dim=1, keepdim=True)
        loss = -logp.gather(1, batch["label"][:, None]).mean()
        grads = torch.autograd.grad(loss, self.leaves)
        if self.grads is None:
            self.grads = [g.clone() for g in grads]
        with torch.no_grad():
            for p, m, g in zip(self.leaves, self.momentum, grads):
                m.mul_(cfg["momentum"]).add_(g)
                p.sub_(cfg["lr"] * m)
        return loss.detach()

    def first_grads(self):
        return self.grads


def program(config):
    return Program(config)


def reference(config):
    return Reference(config)


def control(config):
    return Reference(config, lower=True)
