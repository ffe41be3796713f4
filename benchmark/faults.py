"""Faults planted under the timed path, for the check to catch: a program
with one of them stands in the port's place (`harness.run_cell(...,
program=Faulty(program, kind))`). The tests plant each in the port on the
CPU; `calibrate.py` reads them on the card.

  unchanged   a serving step hands back the previous batch's frames; a
              training step leaves the parameters as they were
  half_batch  half of the batch left out (served: its frames copied from
              the other half; trained: the loss's mean over the rest)
  altered     an answer altered where it is made: one frame's corner
              brightened; one leaf's gradient scaled four times
"""

from __future__ import annotations

import torch

KINDS = ("unchanged", "half_batch", "altered")


class Faulty:
    def __init__(self, program, kind: str):
        if kind not in KINDS:
            raise ValueError(kind)
        self.program, self.kind, self.previous = program, kind, None

    def wrap(self, tree):
        return self.program.wrap(tree)

    def serve(self, params, inputs):
        if self.kind == "half_batch":
            b = next(iter(inputs.values())).shape[0]
            half = self.program.serve(params, {k: v[:max(b // 2, 1)]
                                               for k, v in inputs.items()})
            return torch.cat([half, half])[:b]
        out = self.program.serve(params, inputs)
        if self.kind == "altered":
            out = out.clone()
            out[0, :out.shape[1] // 4, :out.shape[2] // 4] += 0.5
        elif self.kind == "unchanged":
            out, self.previous = (self.previous if self.previous is not None
                                  else out), out
        return out

    def trainer(self, tree, lpips_tree, paths):
        return FaultyTrainer(self.program.trainer(tree, lpips_tree, paths),
                             self.kind, paths)


ALTERED_LEAF = "superresolution/block0/conv1/weight"


class FaultyTrainer:
    def __init__(self, inner, kind: str, paths):
        self.inner, self.kind = inner, kind
        self.leaves = inner.leaves
        if kind == "altered":
            i = next(i for i, p in enumerate(paths) if p.endswith(ALTERED_LEAF))
            inner.leaves[i].register_hook(lambda g: g * 4)

    def step(self, image, label):
        if self.kind == "half_batch":
            b = max(image.shape[0] // 2, 1)
            return self.inner.step(image[:b], label[:b])
        if self.kind == "unchanged":
            before = [p.detach().clone() for p in self.leaves]
            loss = self.inner.step(image, label)
            with torch.no_grad():
                for p, b in zip(self.leaves, before):
                    p.copy_(b)
            return loss
        return self.inner.step(image, label)

    def first_grads(self):
        return self.inner.first_grads()
