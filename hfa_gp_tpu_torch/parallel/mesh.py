"""The (data, model) layout of the ranks and the data-parallel helpers
(port of hfa_gp_tpu/parallel/mesh.py).

A `Mesh` is this rank's place in an n_data × n_model grid of ranks and two
process groups: its data group (the ranks of its model index, one for each
data index: they split the batch) and its model group (the ranks of its
data index: they split PartialFC's class table, or each image's rays in
the avatars' render). Ranks are ordered as JAX
orders the devices of a mesh, the model index fastest: rank r is
(r // n_model, r % n_model).

Where JAX's `make_mesh_for_batch` would leave devices idle (a batch that
does not divide over them), the port raises: a rank cannot sit out the
collectives of the others.

The port uses three collectives: all-reduce, all-gather into one tensor
and broadcast. nccl has all three on CUDA tensors, and gloo runs them on
CUDA tensors too (it stages them through host memory itself).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from . import distributed

@dataclass
class Mesh:
    """This rank's place in the (data, model) grid and its groups (None
    where a group has one rank, or outside a process group)."""
    n_data: int = 1
    n_model: int = 1
    rank: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def size(self) -> int:
        return self.n_data * self.n_model


def _group(ranks: list[int], world: int):
    if len(ranks) == 1:
        return None
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks)


def make_mesh(n_data: int, n_model: int = 1) -> Mesh:
    """The mesh over every rank of the process group (one rank outside
    one). Every rank calls it, in the same order as the others."""
    rank, world = distributed.world()
    if n_data * n_model != world:
        raise ValueError(
            f"a mesh of {n_data} x {n_model} (data x model) needs "
            f"{n_data * n_model} ranks; the world has {world}")
    mesh = Mesh(n_data, n_model, rank)
    # every rank creates every group, in one order (new_group is collective)
    for j in range(n_model):
        g = _group([i * n_model + j for i in range(n_data)], world)
        if j == mesh.model_index:
            mesh.data_group = g
    for i in range(n_data):
        g = _group([i * n_model + j for j in range(n_model)], world)
        if i == mesh.data_index:
            mesh.model_group = g
    return mesh


def mesh_shape_for_batch(batch_size: int, n_model: int, n_devices: int
                         ) -> tuple[int, int]:
    """JAX's rule: the largest data axis that divides the batch within
    what the model axis leaves of the devices."""
    avail = max(n_devices // n_model, 1)
    n_data = max(d for d in range(1, avail + 1) if batch_size % d == 0)
    return n_data, n_model


def make_mesh_for_batch(batch_size: int, n_model: int = 1) -> Mesh:
    """A mesh whose data axis divides the global batch; raises where JAX
    would leave devices idle."""
    _, world = distributed.world()
    if n_model > world:
        raise ValueError(f"n_model {n_model} needs {n_model} ranks or more; "
                         f"the world has {world}")
    n_data, _ = mesh_shape_for_batch(batch_size, n_model, world)
    if n_data * n_model != world:
        raise ValueError(
            f"batch_size {batch_size} with n_model {n_model} does not "
            f"spread over the {world} ranks (a {n_data} x {n_model} mesh "
            f"would leave {world - n_data * n_model} idle): pick a batch "
            "that the data axis divides")
    return make_mesh(n_data, n_model)


def row_range(n: int, index: int, count: int) -> tuple[int, int]:
    """Rows [index·n/count, (index+1)·n/count) of n."""
    if n % count:
        raise ValueError(f"global batch {n} must divide over {count} "
                         "data-parallel ranks")
    local = n // count
    return index * local, (index + 1) * local


def process_local_batch(tree, mesh: Mesh):
    """This rank's rows of a global batch (a tensor, array or a tuple,
    list or dict of them): the slice of its data index."""
    if mesh.n_data == 1:
        return tree
    if isinstance(tree, (tuple, list)):
        return type(tree)(process_local_batch(x, mesh) for x in tree)
    if isinstance(tree, dict):
        return {k: process_local_batch(v, mesh) for k, v in tree.items()}
    lo, hi = row_range(tree.shape[0], mesh.data_index, mesh.n_data)
    return tree[lo:hi]


def process_slice(seq, mesh: Mesh):
    """This rank's contiguous share of a global per-batch sequence (the
    frame indices of one reenactment batch)."""
    if mesh.n_data == 1:
        return seq
    lo, hi = row_range(len(seq), mesh.data_index, mesh.n_data)
    return seq[lo:hi]


# -- collectives (no autograd) ----------------------------------------------


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """In place over `group`; nothing to do for a group of one (None)."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate the ranks' x along dim 0 in group order, on every rank
    of the group; nothing to do for a group of one (None)."""
    if group is None:
        return x
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],
                       *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def host_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The data-sharded x (this rank's rows) → the whole array on every
    rank."""
    return gather_rows(x, mesh.data_group)


@torch.no_grad()
def replicate(tensors) -> None:
    """Broadcast rank 0's values of `tensors` (a module's parameters and
    buffers, or a list) to every rank, in place."""
    if distributed.world()[1] == 1:
        return
    if isinstance(tensors, torch.nn.Module):
        tensors = [*tensors.parameters(), *tensors.buffers()]
    for t in tensors:
        dist.broadcast(t.data, src=0)


@torch.no_grad()
def join_grads(params, group, scale: float = 1.0) -> None:
    """Sum the gradients of `params` (a module or a list of tensors) over
    `group` and multiply them by `scale`, in place, as one flat
    all-reduce."""
    if group is None and scale == 1.0:
        return
    if isinstance(params, torch.nn.Module):
        params = list(params.parameters())
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, group)
    if scale != 1.0:
        flat.mul_(scale)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def data_parallel_step(params, metrics: dict[str, torch.Tensor],
                       mesh: Mesh | None) -> dict[str, torch.Tensor]:
    """After the backward of a loss that is the mean over this rank's
    rows: the gradients of `params` and the detached `metrics` averaged
    over the data axis, so that N ranks at a global batch B step as one
    rank at B and report its loss terms.

    The gradients join over the whole world, scaled by 1/(n_data·n_model):
    the ranks of a model group hold equal gradients (the render's
    boundaries, `into_render`, sum its parts), so the world's mean is the
    data axis's, and every rank then holds the same bits: the model
    ranks' replicas cannot drift apart by the card's run-to-run
    differences."""
    if mesh is None or mesh.size == 1:
        return metrics
    join_grads(params, world_group(), 1.0 / mesh.size)
    if mesh.data_group is None:
        return metrics
    keys = list(metrics)
    vals = all_reduce_(torch.stack([metrics[k].float() for k in keys]),
                       mesh.data_group) / mesh.n_data
    return dict(zip(keys, vals.unbind()))


def world_group():
    """The group of every rank, or None for one process."""
    return dist.group.WORLD if distributed.world()[1] > 1 else None


# -- collectives with autograd, for a loss that every rank holds whole --------
#
# Every rank computes the same global loss (JAX's out_specs=P()). So the
# backward of each collective hands each rank the derivative of that one
# loss with respect to its own input: a sum over the model axis passes its
# cotangent back unchanged (an all-reduce in the backward would count the
# loss n_model times), and the data-axis gather of the batch passes back
# this rank's rows, summed over the model axis, whose class shards each
# contributed a part of the derivative.


class _SumModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.b = mesh, x.shape[0]
        out = gather_rows(x, mesh.data_group)
        return x.clone() if out is x else out

    @staticmethod
    def backward(ctx, g):
        mesh, b = ctx.mesh, ctx.b
        mine = g[mesh.data_index * b:(mesh.data_index + 1) * b].clone()
        return all_reduce_(mine, mesh.model_group), None


def sum_model(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Sum over the model axis; the gradient passes back unchanged."""
    if mesh is None or mesh.model_group is None:
        return x
    return _SumModel.apply(x, mesh.model_group)


def max_model(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Max over the model axis, without gradient (a softmax's shift)."""
    x = x.detach()
    if mesh is None or mesh.model_group is None:
        return x
    return all_reduce_(x.clone(), mesh.model_group, dist.ReduceOp.MAX)


def gather_data(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The global batch from each data index's rows; differentiable when x
    is (see above): with one data index too, the backward sums the
    derivative over the model axis."""
    if mesh is None or mesh.size == 1:
        return x
    if not x.requires_grad:
        return gather_rows(x, mesh.data_group)
    return _GatherData.apply(x, mesh)


# -- the render's boundaries under ray sharding --------------------------------
#
# Each rank of a model group renders a contiguous share of every image's
# rays from replicated planes and decoder params; every rank then holds the
# whole image and the whole loss. Out of the render, the rays' outputs are
# gathered, and the backward hands each rank the cotangent of its own rays
# as it is (each rank's copy of the loss is the one loss, so no sum). Into
# the render, the inputs pass unchanged, and the backward sums their
# gradients over the model group: each rank's render saw its own rays
# only, and the sum is what one render of all the rays gives.


class _IntoRender(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in gs]), ctx.group)
        out, off = [], 0
        for g in gs:
            out.append(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        return (None, *out)


class _GatherRays(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.r = mesh, x.shape[1]
        whole = gather_rows(x.transpose(0, 1).contiguous(), mesh.model_group)
        return whole.transpose(0, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        m, r = ctx.mesh.model_index, ctx.r
        return g[:, m * r:(m + 1) * r].contiguous(), None


def ray_shard(mesh: Mesh | None) -> bool:
    """Whether `mesh` splits the rays of each image (a model axis)."""
    return mesh is not None and mesh.model_group is not None


def ray_range(n: int, mesh: Mesh) -> tuple[int, int]:
    """This rank's rays [m·n/M, (m+1)·n/M) of n, for model index m of M;
    raises where M does not divide n (JAX pads an uneven shard)."""
    if n % mesh.n_model:
        raise ValueError(f"ray sharding: {n} rays do not divide over "
                         f"n_model {mesh.n_model}")
    local = n // mesh.n_model
    return mesh.model_index * local, (mesh.model_index + 1) * local


def into_render(tensors: list[torch.Tensor], mesh: Mesh | None
                ) -> list[torch.Tensor]:
    """The replicated inputs of a ray-sharded render (planes, decoder
    params), unchanged; in the backward their gradients are summed over the
    model group, in one all-reduce."""
    if not ray_shard(mesh) or not torch.is_grad_enabled() \
            or not any(t.requires_grad for t in tensors):
        return tensors
    return list(_IntoRender.apply(mesh.model_group, *tensors))


def gather_rays(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """(B, R/M, ·) of this rank's rays → (B, R, ·) of all, in model-index
    order; the backward returns this rank's rays' cotangent, unsummed."""
    if not ray_shard(mesh):
        return x
    return _GatherRays.apply(x, mesh)


def model_min_max(lo: torch.Tensor, hi: torch.Tensor, mesh: Mesh | None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(min of lo, max of hi) over the model group, without gradient."""
    lo, hi = lo.detach(), hi.detach()
    if not ray_shard(mesh):
        return lo, hi
    both = torch.stack([-lo, hi])       # one MAX all-reduce for both
    all_reduce_(both, mesh.model_group, dist.ReduceOp.MAX)
    return -both[0], both[1]
