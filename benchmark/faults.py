"""Faults planted under the timed path, for the check to catch: a program
with one of them stands in the port's place (`harness.run_cell(...,
program=planted(adapter, config, kind))`). The tests plant each in the
port on the CPU; `calibrate.py` reads them on the card.

  unchanged   a serving step hands back the previous batch's frames; a
              training step leaves the parameters as they were
  half_batch  half of the batch left out (served: its frames copied from
              the other half; trained: every tensor of the batch cut to
              its first half, so the loss is the mean over the rest)
  altered     an answer altered where it is made: one frame's corner
              brightened; the gradient of the leaf that the adapter names
              (its `ALTERED_LEAF`) scaled four times
"""

from __future__ import annotations

import torch

KINDS = ("unchanged", "half_batch", "altered")


def planted(adapter, config: dict, kind: str):
    """The adapter's program for `config` with the fault `kind` planted."""
    return Faulty(adapter.program(config), kind,
                  getattr(adapter, "ALTERED_LEAF", None))


def _half(batch: dict) -> dict:
    b = max(next(iter(batch.values())).shape[0] // 2, 1)
    return {k: v[:b] for k, v in batch.items()}


class Faulty:
    def __init__(self, program, kind: str, altered_leaf: str | None = None):
        if kind not in KINDS:
            raise ValueError(kind)
        self.program, self.kind, self.previous = program, kind, None
        self.altered_leaf = altered_leaf

    def wrap(self, tree):
        return self.program.wrap(tree)

    def serve(self, params, inputs):
        if self.kind == "half_batch":
            b = next(iter(inputs.values())).shape[0]
            half = self.program.serve(params, _half(inputs))
            return torch.cat([half, half])[:b]
        out = self.program.serve(params, inputs)
        if self.kind == "altered":
            out = out.clone()
            out[0, :out.shape[1] // 4, :out.shape[2] // 4] += 0.5
        elif self.kind == "unchanged":
            out, self.previous = (self.previous if self.previous is not None
                                  else out), out
        return out

    def trainer(self, tree, aux_tree, paths):
        return FaultyTrainer(self.program.trainer(tree, aux_tree, paths),
                             self.kind, paths, self.altered_leaf)


class FaultyTrainer:
    def __init__(self, inner, kind: str, paths, altered_leaf=None):
        self.inner, self.kind = inner, kind
        self.leaves = inner.leaves
        if kind == "altered":
            if altered_leaf is None:
                raise ValueError("the adapter names no ALTERED_LEAF")
            i = next(i for i, p in enumerate(paths)
                     if p.endswith(altered_leaf))
            inner.leaves[i].register_hook(lambda g: g * 4)

    def step(self, batch):
        if self.kind == "half_batch":
            return self.inner.step(_half(batch))
        if self.kind == "unchanged":
            before = [p.detach().clone() for p in self.leaves]
            loss = self.inner.step(batch)
            with torch.no_grad():
                for p, b in zip(self.leaves, before):
                    p.copy_(b)
            return loss
        return self.inner.step(batch)

    def first_grads(self):
        return self.inner.first_grads()
