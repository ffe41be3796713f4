"""PartialFC: the margin-softmax classifier over a table of class centres
(port of hfa_gp_tpu/parallel/partial_fc.py).

  * `combined_margin` and its ArcFace / CosFace forms are plain functions;
  * the softmax cross-entropy never materialises the (B, classes) logits on
    the card: its statistics come from the flash-CE kernels
    (`core/kernels/flash_ce.py`), at any batch, width and class count. On
    CPU tensors the same call takes the kernels' plain version;
  * `sample_rate < 1` keeps every positive class centre and random
    negatives each step; the trainer then differentiates with respect to
    the gathered rows only (`loss_sampled`), so no table-sized gradient
    exists;
  * over a `parallel.mesh.Mesh` of several ranks the table is sharded over
    the model axis: each rank holds the num_classes / n_model rows of its
    model index, the batch is gathered over the data axis (each rank
    passes its own rows), and the shards' statistics are joined with a max
    and a sum over the model axis (`mesh.max_model`, `mesh.sum_model`),
    whose backwards are written for a loss that every rank holds whole.
    The kernels run on the shard's rows with the global batch, unchanged.

The JAX package's blockwise statistics (`_make_blockwise_stats`) work
around the TPU's memory traffic; the kernel takes their place here.
"""

from __future__ import annotations

import math

import torch

from ..core.kernels import flash_ce
from . import mesh as mesh_mod

# ---------------------------------------------------------------------------
# Margin losses (CombinedMarginLoss: m1·θ + m2 margin, −m3 offset)
# ---------------------------------------------------------------------------


def combined_margin(target_logit: torch.Tensor, m1: float, m2: float,
                    m3: float) -> torch.Tensor:
    """cos(m1·θ + m2) − m3 applied to the target-class cosine.

    The m1 = 1 ArcFace branch is cos(θ + m2) by the explicit
    t·cos m − √(1−t²)·sin m product, with the linear fallback
    t − sin(π−m2)·m2 once θ + m2 would pass π (plain cos(θ+m2) turns back
    up there). The √(1−t²) derivative diverges at |t| = 1; the ε-clip keeps
    gradients finite at cosines that saturate the [−1, 1] clip."""
    if m1 == 1.0 and m2 == 0.0:
        return target_logit - m3
    t = target_logit
    tc = torch.clamp(t, -1.0 + 1e-6, 1.0 - 1e-6)
    if m1 == 1.0:
        sin_theta = torch.sqrt(1.0 - tc * tc)
        cos_theta_m = t * math.cos(m2) - sin_theta * math.sin(m2)
        fallback = t - math.sin(math.pi - m2) * m2
        return torch.where(t > math.cos(math.pi - m2),
                           cos_theta_m, fallback) - m3
    theta = torch.acos(tc)
    return torch.cos(m1 * theta + m2) - m3


def arcface_margin(target_logit: torch.Tensor, m: float = 0.5
                   ) -> torch.Tensor:
    return combined_margin(target_logit, 1.0, m, 0.0)


def cosface_margin(target_logit: torch.Tensor, m: float = 0.4
                   ) -> torch.Tensor:
    return combined_margin(target_logit, 1.0, 0.0, m)


# ---------------------------------------------------------------------------
# Margin-softmax CE core (shared by loss / loss_sampled)
# ---------------------------------------------------------------------------


def _ce_stats_direct(norm_emb: torch.Tensor, w_used: torch.Tensor,
                     local_lab: torch.Tensor, s: float, m1: float,
                     m2: float, m3: float, mm_dtype=None):
    """The plain reference of the whole CE: materialises the full
    (B, rows) logits. Returns (local_max [no gradient], sum_exp relative
    to local_max, tgt_logit margined and scaled)."""
    norm_w = w_used / torch.linalg.vector_norm(w_used, dim=1, keepdim=True)
    ne = norm_emb
    if mm_dtype is not None:
        ne = ne.to(mm_dtype).to(torch.float32)
        norm_w = norm_w.to(mm_dtype).to(torch.float32)
    logits = torch.clamp(ne @ norm_w.T, -1.0, 1.0)

    has_target = local_lab >= 0
    cols = torch.clamp(local_lab, min=0).long()
    tgt = logits.gather(1, cols[:, None])[:, 0]
    tgt_m = combined_margin(tgt, m1, m2, m3)

    # the max shift carries no gradient in a softmax
    local_max = (torch.maximum(logits.max(dim=1).values, tgt_m)
                 * s).detach()
    se = torch.exp(logits * s - local_max[:, None]).sum(1)
    # the margin as an O(B) correction to the row sums
    corr = torch.exp(tgt_m * s - local_max) - torch.exp(tgt * s - local_max)
    se = se + torch.where(has_target, corr, torch.zeros_like(corr))
    tgt_logit = torch.where(has_target, tgt_m * s, torch.zeros_like(tgt_m))
    return local_max, se, tgt_logit


def _margin_softmax_ce(emb: torch.Tensor, w_used: torch.Tensor,
                       local_lab: torch.Tensor, s: float, m1: float,
                       m2: float, m3: float, mm_dtype=None,
                       direct: bool = False, mesh=None) -> torch.Tensor:
    """emb (B, d) the batch, w_used (rows, d) this shard's class centres
    (all of them or the sampled ones), local_lab (B,) the column of each
    row's positive in w_used or −1. Margin on the target column, then the
    softmax CE. Returns a scalar.

    mm_dtype: None or torch.bfloat16, the type the operands of the cosine
    product are rounded to (fp32 accumulation); norms, margin and softmax
    stay fp32.

    The statistics come from `flash_ce.flash_ce_stats`: the kernels on
    CUDA tensors, their plain version on CPU tensors. `direct=True` takes
    `_ce_stats_direct` instead (the reference the tests hold both to).

    mesh: the `parallel.mesh.Mesh` whose model axis shards the classes
    (None: one shard). emb is then the global batch on every rank."""
    norm_emb = emb / torch.linalg.vector_norm(emb, dim=1, keepdim=True)
    b = norm_emb.shape[0]
    has_target = local_lab >= 0
    if direct:
        local_max, se, tgt_logit = _ce_stats_direct(
            norm_emb, w_used, local_lab, s, m1, m2, m3, mm_dtype)
    else:
        se_x, tgt_raw = flash_ce.flash_ce_stats(
            norm_emb.contiguous(), w_used, local_lab.to(torch.int32),
            float(s), mm_dtype)
        tgt_m = combined_margin(tgt_raw, m1, m2, m3)
        # the kernel leaves the target column out of its sum; the margined
        # term is added back here with the same exp that gives tgt_logit,
        # so denom ≥ the target's term holds by construction
        zero = torch.zeros_like(tgt_m)
        se = se_x + torch.where(has_target, torch.exp(tgt_m * s - s), zero)
        tgt_logit = torch.where(has_target, tgt_m * s, zero)
        local_max = torch.full((b,), float(s), dtype=torch.float32,
                               device=emb.device)

    # the kernels' shift is s on every shard: the max over the model axis
    # is only needed on the direct route
    gmax = local_max if not direct else mesh_mod.max_model(local_max, mesh)
    # the fixed shift can underflow se to exactly 0 when every cosine sits
    # below about 1 − 87/s; floor the denominator so log() stays finite.
    # The three sums over the model axis go as one
    terms = torch.stack([
        se * torch.exp(local_max - gmax),
        torch.where(has_target, tgt_logit - gmax, torch.zeros_like(tgt_logit)),
        has_target.to(torch.float32)])
    denom, tgt_term, valid = mesh_mod.sum_model(terms, mesh)
    denom = torch.clamp(denom, min=1e-30)
    per_sample = (torch.log(denom) - tgt_term) * torch.clamp(valid, max=1.0)
    n_valid = torch.clamp(torch.clamp(valid, max=1.0).sum(), min=1.0)
    return per_sample.sum() / n_valid


# ---------------------------------------------------------------------------
# Per-shard sampling helpers
# ---------------------------------------------------------------------------


def _shard_local_labels(lab: torch.Tensor, shard_idx: int,
                        num_local: int) -> torch.Tensor:
    """Global labels → this shard's local class column, −1 if not ours."""
    lo = shard_idx * num_local
    return torch.where((lab >= lo) & (lab < lo + num_local), lab - lo,
                       torch.full_like(lab, -1))


def _sample_shard_indices(local_lab: torch.Tensor,
                          generator: torch.Generator, num_local: int,
                          num_sample: int) -> torch.Tensor:
    """Sorted sampled class indices of one shard: every positive (priority
    2.0 by a scatter-max, so a write to index 0 from a row without a
    positive can never displace a real class-0 positive) and random
    negatives. The kept count is max(num_sample, min(B, num_local)), which
    has room for every distinct positive."""
    b = local_lab.shape[0]
    k = min(num_local, max(num_sample, min(b, num_local)))
    perm = torch.rand((num_local,), generator=generator,
                      device=local_lab.device)
    has = local_lab >= 0
    pos = torch.where(has, local_lab, torch.zeros_like(local_lab)).long()
    prio = torch.where(has, 2.0, -math.inf).to(perm.dtype)
    perm = perm.scatter_reduce(0, pos, prio, "amax", include_self=True)
    index = torch.topk(perm, k).indices
    return torch.sort(index).values


def _remap_to_sampled(local_lab: torch.Tensor, index: torch.Tensor
                      ) -> torch.Tensor:
    """Local class columns → columns of the sorted sampled index array
    (positives are always sampled; rows without a positive stay −1)."""
    k = index.shape[0]
    lab = local_lab.to(index.dtype)
    remap = torch.searchsorted(index, torch.clamp(lab, min=0))
    hit = (lab >= 0) & (index[torch.clamp(remap, 0, k - 1)] == lab)
    return torch.where(hit, remap, torch.full_like(remap, -1))


# ---------------------------------------------------------------------------
# PartialFC
# ---------------------------------------------------------------------------


def _shard_generator(generator: torch.Generator, shard: int,
                     n_model: int) -> torch.Generator:
    """The sampling generator of one class shard: the step's own with one
    shard, else one seeded from (a draw of the step's generator, shard
    index), as JAX's fold_in(key, shard_idx). Every rank of a shard holds
    the step's generator in one state, so they sample alike, the shards
    differently, and the draw advances it as sampling would."""
    if n_model == 1:
        return generator
    draw = int(torch.randint(2 ** 62, (1,), generator=generator,
                             device=generator.device))
    seed = (draw * 65_537 + 1 + shard) % 2 ** 63
    return torch.Generator(generator.device).manual_seed(seed)


class PartialFC:
    """Margin softmax over a table of (num_classes, embedding_dim) class
    centres; labels are int (B,), −1 = no positive class.

    On a `mesh` with a model axis of n_model, `num_classes` must divide
    (the CLI pads it, as JAX's does) and the rank holds the rows of its
    model index (`init`); `loss` and `loss_sampled` take the rank's rows of
    the batch and return the loss of the global batch on every rank."""

    def __init__(self, num_classes: int, embedding_dim: int = 512, *,
                 s: float = 64.0, m1: float = 1.0, m2: float = 0.5,
                 m3: float = 0.0, sample_rate: float = 1.0,
                 matmul_dtype=None, mesh: mesh_mod.Mesh | None = None):
        n_model = mesh.n_model if mesh is not None else 1
        if num_classes % n_model:
            raise ValueError(f"num_classes {num_classes}: pad it to a "
                             f"multiple of the model axis ({n_model})")
        self.mesh = mesh
        self.n_model = n_model
        self.shard = mesh.model_index if mesh is not None else 0
        self.num_classes = num_classes
        self.num_local = num_classes // n_model
        self.embedding_dim = embedding_dim
        self.s, self.m1, self.m2, self.m3 = s, m1, m2, m3
        self.matmul_dtype = matmul_dtype
        self.sample_rate = sample_rate
        self.num_sample = max(1, int(sample_rate * self.num_local))

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cpu") -> torch.Tensor:
        """N(0, 0.01²) class centres, made on `device` by a generator of
        that device: this rank's rows of the one seeded table, so that the
        table does not depend on the mesh. The whole table is drawn once
        and dropped after the shard's rows are copied out."""
        table = torch.randn((self.num_classes, self.embedding_dim),
                            generator=generator, device=device,
                            dtype=torch.float32)
        if self.n_model > 1:
            lo = self.shard * self.num_local
            table = table[lo:lo + self.num_local].clone()
        return table.mul_(0.01)

    def _local_labels(self, labels: torch.Tensor) -> torch.Tensor:
        """The global batch's labels as this shard's columns."""
        lab = mesh_mod.gather_data(labels, self.mesh)
        return _shard_local_labels(lab, self.shard, self.num_local)

    # -- sparse sampling (gradients only ever touch sampled rows) -----------

    def sample_indices(self, labels: torch.Tensor,
                       generator: torch.Generator) -> torch.Tensor:
        """Sorted sampled class indices (int64) of this rank's shard: all
        positives of the global batch and random negatives. Computed
        outside the loss so that the train step can gather the sub-weight
        first and differentiate with respect to that: only the
        (num_sample, d) sub-gradient ever exists."""
        return _sample_shard_indices(
            self._local_labels(labels),
            _shard_generator(generator, self.shard, self.n_model),
            self.num_local, self.num_sample)

    def take_rows(self, table: torch.Tensor, index: torch.Tensor
                  ) -> torch.Tensor:
        """Row gather: the shard's table (num_local, d), index from
        sample_indices → (num_sample, d)."""
        return table[index]

    def put_rows(self, table: torch.Tensor, index: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
        """Row scatter, the inverse of take_rows (indices are unique),
        IN PLACE on `table`, which it returns: a copy of the table would
        cost what the row-sparse path exists to save."""
        with torch.no_grad():
            table.index_copy_(0, index, rows)
        return table

    def loss_sampled(self, w_sub: torch.Tensor, embeddings: torch.Tensor,
                     labels: torch.Tensor, index: torch.Tensor
                     ) -> torch.Tensor:
        """Margin-softmax CE against a pre-gathered sampled sub-weight
        (take_rows(weight, sample_indices(...))). Differentiable with
        respect to w_sub, the only weight gradient that ever exists."""
        local_lab = _remap_to_sampled(self._local_labels(labels), index)
        return _margin_softmax_ce(
            mesh_mod.gather_data(embeddings, self.mesh), w_sub, local_lab,
            self.s, self.m1, self.m2, self.m3, self.matmul_dtype,
            mesh=self.mesh)

    # -- the loss -----------------------------------------------------------

    def loss(self, weight: torch.Tensor, embeddings: torch.Tensor,
             labels: torch.Tensor,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """Mean margin-softmax CE over the rows that have a positive;
        `weight` is the shard's rows of the table."""
        local_lab = self._local_labels(labels)
        if self.sample_rate < 1.0:
            if generator is None:
                raise ValueError(
                    "PartialFC.loss with sample_rate < 1 needs a generator "
                    "that advances every step: a fixed one would train "
                    "against the same negative subset forever")
            index = _sample_shard_indices(
                local_lab, _shard_generator(generator, self.shard,
                                            self.n_model),
                self.num_local, self.num_sample)
            w_used = weight[index]
            local_lab = _remap_to_sampled(local_lab, index)
        else:
            w_used = weight
        return _margin_softmax_ce(
            mesh_mod.gather_data(embeddings, self.mesh), w_used, local_lab,
            self.s, self.m1, self.m2, self.m3, self.matmul_dtype,
            mesh=self.mesh)
