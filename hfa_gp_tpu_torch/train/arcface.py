"""Face-recognition trainer: a backbone (iresnet, MobileFaceNet or ViT)
under a PartialFC head (port of hfa_gp_tpu/train/arcface.py), on one rank
or on the (data, model) mesh of the PartialFC's `mesh`. The backbone's
trunk runs in fp32 or bf16 (`make_train_step`'s `dtype`, the JAX
package's AMP analog); its parameters, gradients and optimizer state stay
fp32.

SGD (momentum 0.9, weight decay 5e-4) or AdamW with the poly schedule and
the margin softmax. The backbone's optimizer is `torch.optim.SGD` /
`torch.optim.AdamW` with the learning rate set from the schedule before
every step, and a global-norm clip of the backbone's gradients only. The
head's optimizer is written out, because it has two forms:

  * dense (`sample_rate == 1`): the full-table gradient, with the weight
    decay applied only to rows that received a gradient;
  * row-sparse (`sample_rate < 1`): the step gathers the sampled rows of
    the table and of the optimizer buffers, differentiates with respect to
    the (num_sample, d) sub-weight only, applies torch-SGD or AdamW
    arithmetic to those rows and scatters them back in place. No
    table-sized gradient or optimizer intermediate ever exists; unsampled
    rows keep their buffers as they were; AdamW's bias correction uses the
    global step count.

On a mesh, each rank passes its data index's rows of the global batch;
BatchNorm takes the global batch's statistics (`norm.synced`); the loss is
the global batch's on every rank, and each rank's backbone gradient is the
derivative of that loss through its own rows, so the gradients are summed
over the data axis (as one all-reduce over every rank, divided by n_model,
so that every rank ends with the same bits) before the clip and the
update. The head's update touches only the rank's shard of the table and
of its buffers.

State is updated in place (the JAX package returns new state and donates
the old).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch import nn

from ..models.arcface import norm, registry
from ..models.arcface.scheduler import poly_scheduler
from ..parallel import mesh as mesh_mod
from ..parallel.partial_fc import PartialFC
from ..utils.observability import annotate


@dataclass
class ArcFaceState:
    backbone: nn.Module             # a `ParamTree`
    batch_stats: nn.Module          # a `ParamTree` of BN running moments
    fc_weight: torch.Tensor         # (num_classes / n_model, d): the shard
    optimizer: torch.optim.Optimizer
    fc_opt_state: dict[str, torch.Tensor] = field(default_factory=dict)
    step: int = 0


@dataclass(frozen=True)
class BackboneOptimizer:
    """How to build and drive the backbone's optimizer."""
    sched: Callable[[int], float]
    kind: str                     # "sgd" | "adamw"
    momentum: float
    weight_decay: float
    clip_grad_norm: float | None

    def build(self, params: nn.Module) -> torch.optim.Optimizer:
        if self.kind == "sgd":
            return torch.optim.SGD(params.parameters(), lr=self.sched(0),
                                   momentum=self.momentum,
                                   weight_decay=self.weight_decay)
        return torch.optim.AdamW(params.parameters(), lr=self.sched(0),
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=self.weight_decay)

    def step(self, optimizer: torch.optim.Optimizer, count: int) -> None:
        """Clip the gradients by their global norm (g·max/‖g‖ once ‖g‖
        reaches max, with no host synchronisation), then one update at
        the schedule's rate for update number `count`."""
        if self.clip_grad_norm:
            grads = [p.grad for grp in optimizer.param_groups
                     for p in grp["params"] if p.grad is not None]
            norm = torch.nn.utils.get_total_norm(grads)
            scale = torch.where(norm < self.clip_grad_norm,
                                torch.ones_like(norm),
                                self.clip_grad_norm / norm)
            torch._foreach_mul_(grads, scale)
        for grp in optimizer.param_groups:
            grp["lr"] = self.sched(count)
        optimizer.step()


@dataclass(frozen=True)
class FCOptimizer:
    """The head's optimizer, dense and row-sparse. Buffers: {"mom"} for
    sgd, {"m", "v"} for adamw, each shaped like the table."""
    sched: Callable[[int], float]
    kind: str                     # "sgd" | "adamw"
    momentum: float
    weight_decay: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, weight: torch.Tensor) -> dict[str, torch.Tensor]:
        names = ("m", "v") if self.kind == "adamw" else ("mom",)
        return {n: torch.zeros_like(weight) for n in names}

    def update_rows(self, w: torch.Tensor, g: torch.Tensor,
                    bufs: dict[str, torch.Tensor], count: int,
                    decay_rows: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """New (rows, buffers) for rows `w` with gradient `g` and buffer
        rows `bufs`, at update number `count`. torch-SGD: buf = μ·buf + g +
        wd·w, w −= lr·buf. AdamW: decoupled decay, bias correction with
        count + 1. `decay_rows` (rows, 1), when given, masks the SGD decay
        to the rows it marks."""
        lr = self.sched(count)
        if self.kind == "adamw":
            m = self.b1 * bufs["m"] + (1.0 - self.b1) * g
            v = self.b2 * bufs["v"] + (1.0 - self.b2) * g * g
            t = count + 1
            m_hat = m / (1.0 - self.b1 ** t)
            v_hat = v / (1.0 - self.b2 ** t)
            w_new = w - lr * (m_hat / (torch.sqrt(v_hat) + self.eps)
                              + self.weight_decay * w)
            return w_new, {"m": m, "v": v}
        decay = self.weight_decay * w
        if decay_rows is not None:
            decay = decay * decay_rows
        buf = self.momentum * bufs["mom"] + g + decay
        return w - lr * buf, {"mom": buf}

    @torch.no_grad()
    def update_dense(self, weight: torch.Tensor, grad: torch.Tensor,
                     bufs: dict[str, torch.Tensor], count: int) -> None:
        """The dense head, in place. SGD decays only the rows that
        received a gradient (a row a sampled loss left out keeps its
        centre); AdamW decays every row, as every row sees a gradient."""
        rows = None
        if self.kind == "sgd":
            rows = (grad.abs().sum(-1, keepdim=True) > 0).to(weight.dtype)
        w_new, new = self.update_rows(weight, grad, bufs, count, rows)
        weight.copy_(w_new)
        for k, v in new.items():
            bufs[k].copy_(v)


def make_optimizers(total_steps: int, *, lr: float = 0.1,
                    warmup_steps: int = 0, momentum: float = 0.9,
                    weight_decay: float = 5e-4, optimizer: str = "sgd",
                    clip_grad_norm: float | None = 5.0
                    ) -> tuple[BackboneOptimizer, FCOptimizer]:
    """Backbone and head optimizers. "sgd" is the conv-backbone recipe
    (momentum 0.9, wd 5e-4, poly schedule), "adamw" the ViT one (wd 0.1).
    `clip_grad_norm` clips the backbone's gradients by global norm; the
    head is never clipped."""
    if optimizer not in ("sgd", "adamw"):
        raise ValueError(f"unknown optimizer {optimizer!r} "
                         "(expected 'sgd' or 'adamw')")
    sched = poly_scheduler(lr, total_steps, warmup_steps)
    tx = BackboneOptimizer(sched=sched, kind=optimizer, momentum=momentum,
                           weight_decay=weight_decay,
                           clip_grad_norm=clip_grad_norm or None)
    fc_tx = FCOptimizer(sched=sched, kind=optimizer, momentum=momentum,
                        weight_decay=weight_decay)
    return tx, fc_tx


def init_state(generator: torch.Generator, pfc: PartialFC,
               tx: BackboneOptimizer, fc_tx: FCOptimizer,
               network: str = "iresnet50",
               device: torch.device | str = "cpu") -> ArcFaceState:
    """Seeded state on `device`. The backbone is drawn from `generator`
    (a CPU generator) and moved; the table is drawn on `device` from a
    generator seeded by it, so that a 3,000,000-row table never crosses
    the host link. On a mesh every rank draws the same backbone and keeps
    its shard of the same table."""
    backbone, stats = registry.init_backbone(generator, network,
                                             pfc.embedding_dim, device)
    backbone.requires_grad_(True)
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator))
    fc_weight = pfc.init(torch.Generator(device).manual_seed(seed), device)
    return ArcFaceState(backbone=backbone, batch_stats=stats,
                        fc_weight=fc_weight, optimizer=tx.build(backbone),
                        fc_opt_state=fc_tx.init(fc_weight), step=0)


def _store_stats(batch_stats: nn.Module, new: dict[str, Any]) -> None:
    with torch.no_grad():
        for k, v in new.items():
            if isinstance(v, dict):
                _store_stats(batch_stats[k], v)
            else:
                batch_stats[k].copy_(v)


@torch.no_grad()
def update_head(pfc: PartialFC, fc_tx: FCOptimizer, state: ArcFaceState,
                head: torch.Tensor, index: torch.Tensor | None) -> None:
    """One update of the table and its buffers, in place, from `head.grad`:
    `head` is the whole table (index None), or the rows `index` of it, of
    which only those rows and their buffer rows are read and written."""
    if index is None:
        fc_tx.update_dense(state.fc_weight, head.grad, state.fc_opt_state,
                           state.step)
        return
    bufs = {k: pfc.take_rows(v, index)
            for k, v in state.fc_opt_state.items()}
    w_new, new = fc_tx.update_rows(head.detach(), head.grad, bufs,
                                   state.step)
    pfc.put_rows(state.fc_weight, index, w_new)
    for k, v in new.items():
        pfc.put_rows(state.fc_opt_state[k], index, v)


def make_train_step(pfc: PartialFC, tx: BackboneOptimizer,
                    fc_tx: FCOptimizer, network: str = "iresnet50",
                    dtype: torch.dtype = torch.float32):
    """step_fn(state, images, labels, generator, index=None) → {"loss"}.

    `dtype` is the backbone trunk's (torch.bfloat16 for the JAX CLI's
    default); the head's products take `pfc.matmul_dtype`. The step's
    generator also feeds the ViTs' drop path and masking (drawn before the
    head's sampling; the other backbones draw nothing from it).

    sample_rate == 1: the dense head (full-table gradient).
    sample_rate < 1: the row-sparse head. It differentiates with respect
    to the gathered (num_sample, d) sub-weight and steps only those rows
    and their buffer rows, so the head's peak memory is table + buffers +
    the sampled rows' working set. `index` replaces the sampled class
    indices (the tests inject another package's).

    On `pfc.mesh`, images and labels are the rank's rows of the global
    batch, and `index` the rank's shard's sampled indices.

    Profiler ranges (`utils.observability.annotate`): "train_step" holding
    "forward" ("embed": the backbone; "sample": the class draw and the row
    gather, row-sparse only; "margin_ce": the flash-CE statistics, the
    margin and the loss), "backward", and "optimizer" (the join over the
    data axis, the backbone's clip and update, and "head_update": the
    table's rows and their buffers, updated and scattered back)."""
    sparse = pfc.sample_rate < 1.0
    mesh = pfc.mesh if pfc.mesh is not None else mesh_mod.Mesh()

    def bn_sync():
        if mesh.n_data == 1:
            return contextlib.nullcontext()
        return norm.synced(mesh)

    join = mesh_mod.world_group() if mesh.size > 1 else None

    def step_fn(state: ArcFaceState, images: torch.Tensor,
                labels: torch.Tensor,
                generator: torch.Generator | None = None,
                index: torch.Tensor | None = None) -> dict[str, Any]:
        with annotate("train_step"):
            state.optimizer.zero_grad(set_to_none=True)
            with annotate("forward"):
                with annotate("embed"), bn_sync():
                    emb, new_stats = registry.backbone_apply(
                        network, state.backbone, state.batch_stats, images,
                        train=True, dtype=dtype, generator=generator)
                if sparse:
                    with annotate("sample"):
                        if index is None:
                            index = pfc.sample_indices(labels, generator)
                        head = pfc.take_rows(state.fc_weight, index) \
                            .requires_grad_(True)
                    with annotate("margin_ce"):
                        loss = pfc.loss_sampled(head, emb, labels, index)
                else:
                    head = state.fc_weight.detach().requires_grad_(True)
                    with annotate("margin_ce"):
                        loss = pfc.loss(head, emb, labels)
            with annotate("backward"):
                loss.backward()
            with annotate("optimizer"):
                # the data axis's parts of the backbone's gradient, before
                # the clip
                mesh_mod.join_grads(state.backbone, join, 1.0 / mesh.n_model)
                tx.step(state.optimizer, state.step)
                with annotate("head_update"):
                    update_head(pfc, fc_tx, state, head,
                                index if sparse else None)
                _store_stats(state.batch_stats, new_stats)
            state.step += 1
        return {"loss": loss.detach()}

    return step_fn
