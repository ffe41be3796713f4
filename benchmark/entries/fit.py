"""Fitting: training steps issued back to back on one state (a closed
loop whose window ends with a synchronise).

Set-up builds the state once, in the phase in which every parameter
trains, and drives it through its first steps on rows that all differ,
through the same call the window makes; the same state then trains in
the window. After the window closes, the plain reference follows those
first steps from the same weights and rows, and the check compares:

  * `loss_gap`: each first step's loss, |port − ref| / |ref|, worst step;
  * `grad_gap`: the first gradient as the optimizer got it (the trainer's
    `first_grads`, read from the optimizer's state after one step), per
    leaf, |‖g‖ − ‖g_ref‖| over the larger of ‖g_ref‖ and the median leaf's,
    worst leaf;
  * `change_gap`: each leaf's change over the first steps, the same way,
    over the leaves that the reference's gradient reaches (a leaf whose
    reference gradient is under a thousandth of the median leaf's moves
    under an adaptive optimizer by round-off alone, and is left out), the
    median leaf's gap. Not the worst leaf's: Adam takes a full step of
    either sign for each element whose gradient is within round-off of
    zero, so the worst leaf's gap swings from seed to seed over two
    decades in sound runs (kept in `run.notes` for `calibrate.py`).

The adapter gives the weights (`spec`), the input pool (`inputs`) and,
where the loss needs one, a second tree of fixed weights (`aux_spec`),
each drawn on its own stream of the seed; trainers are built as
`trainer(tree, aux_tree or None, paths)` and stepped with a batch dict.
"""

from __future__ import annotations

import torch

from .. import inputs, weights

WEIGHTS_STREAM = 1
AUX_STREAM = 2
REACHED = 1e-3          # a leaf's share of the median leaf's gradient


def _norms(ts) -> torch.Tensor:
    return torch.stack([t.detach().float().norm() for t in ts]).cpu()


def gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each leaf's |‖got‖ − ‖want‖| / max(‖want‖, the median leaf's)."""
    median = want[want > 0].median() if (want > 0).any() else want.new_ones(())
    return (got - want).abs() / torch.maximum(want, median)


def first_steps(trainer, batches, n, mark=None):
    """n steps on the first n batches → (losses, first gradients' norms,
    the leaves' values before) with the norms taken after step one;
    `mark(phase)` after each, where given."""
    before = [p.detach().clone() for p in trainer.leaves]
    losses, g1 = [], None
    for k in range(n):
        losses.append(trainer.step(batches[k]))
        if k == 0:
            g1 = _norms(trainer.first_grads())
        if mark is not None:
            mark("first step" if k == 0 else "warm-up")
    change = _norms([p.detach() - b for p, b in zip(trainer.leaves, before)])
    return torch.stack([l.detach().float() for l in losses]).cpu(), g1, change


def aux_tree(r):
    """The adapter's second tree of fixed weights, drawn on AUX_STREAM, or
    None where the adapter has none."""
    aux = getattr(r.adapter, "aux_spec", None)
    spec = aux(r.config) if aux is not None else None
    if not spec:
        return None
    return weights.make(spec, r.seed, AUX_STREAM, r.device)[0]


def run(r) -> dict:
    t = r.traffic
    spec = r.adapter.spec(r.config)
    paths = [p for p, *_ in spec]
    tree, bufs = weights.make(spec, r.seed, WEIGHTS_STREAM, r.device)
    ref_tree, _ = weights.clone(spec, bufs)
    aux = aux_tree(r)
    batches = inputs.batches(r.adapter.inputs(r.config, t, r.seed, r.device),
                             t["batch"])
    n0 = t["first_steps"]
    r.mark("weights and inputs")
    trainer = r.program.trainer(tree, aux, paths)
    r.mark("state")
    losses, g1, change = first_steps(trainer, batches, n0, r.mark)

    with r.window():
        i = n0
        while not r.done():
            trainer.step(batches[i % len(batches)])
            i += 1
        r.units = i - n0

    r.attribute(lambda j: trainer.step(batches[(i + j) % len(batches)]))
    del trainer, tree, bufs
    r.release()

    ref = r.adapter.reference(r.config).trainer(ref_tree, aux, paths)
    ref_losses, ref_g1, ref_change = first_steps(ref, batches, n0)
    reached = ref_g1 >= REACHED * ref_g1[ref_g1 > 0].median()
    grad = gaps(g1, ref_g1)
    moved = gaps(change[reached], ref_change[reached])
    kept = [p for p, k in zip(paths, reached) if k]
    r.notes = {"grad_gap_leaf": paths[int(grad.argmax())],
               "change_gap_worst": float(moved.max()),
               "change_gap_worst_leaf": kept[int(moved.argmax())],
               "leaves_left_out": int((~reached).sum())}
    return {"loss_gap": float(((losses - ref_losses).abs()
                               / ref_losses.abs()).max()),
            "grad_gap": float(grad.max()),
            "change_gap": float(moved.median())}
