"""Collectives over the mesh's axes (port of ``ctpa/comms/collectives.py``).

ctpa's collectives are XLA ops that JAX differentiates; here each is an
explicit ``torch.distributed`` call, and where one sits on a differentiated
path it is a ``torch.autograd.Function`` whose backward is the transpose
JAX derives:

  * ``all_gather`` (and ``all_gather_batch``): the ranks' blocks
    concatenated; the backward sums each block's gradient over the ranks
    and keeps this rank's (a reduce-scatter).  Every rank's loss reads every
    block, so the sum is the whole gradient of the sum of the ranks' losses.
  * ``all_reduce``: the sum over ranks; the backward is the identity (the
    computation after it is replicated, so each rank's gradient of the sum
    is the whole one already).
  * ``replicated``: its transpose: the identity, whose backward sums the
    ranks' partial gradients (an all-reduce); a tensor every rank holds,
    entering a region where each rank computes its part.
  * ``shard`` / ``gather_replicated``: the entry into and exit from a
    sequence-sharded region of a replicated computation: this rank's block
    (backward: the blocks' gradients gathered) and the blocks gathered
    (backward: this rank's block of the replicated gradient).

Both backends run the tensor collectives (``all_gather_into_tensor``,
``reduce_scatter_tensor``, which gloo has too), so the CPU tests take the
card's code path.  Every result is contiguous (the flash kernels take no
other layout).
``psum``/``pmean`` reduce values nothing differentiates (metrics, counts);
``average_gradients`` is the data-parallel gradient reduction.  Over a
mesh with no process group (``single_device_mesh``) every one of them is
the identity.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist

from ctpa_torch.core.mesh import DATA_AXIS, Mesh


def axis_present(mesh, axis: str) -> bool:
    """True if ``mesh`` is a mesh with an axis named ``axis``."""
    return mesh is not None and axis in mesh.axis_names


def axis_index(mesh: Mesh, axis: str = DATA_AXIS) -> int:
    return mesh.index(axis)


def _live(mesh: Mesh, axis: str, x: torch.Tensor):
    """The axis's process group, or None when the collective is the identity."""
    group = mesh.group(axis)
    if group is not None:
        mesh.check(x)
    return group


def _gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    group = _live(mesh, axis, x)
    if group is None:
        return x
    # the tensor collectives work on dim 0
    lead = x.movedim(dim, 0).contiguous()
    out = lead.new_empty((mesh.size(axis) * lead.shape[0],) + tuple(lead.shape[1:]))
    dist.all_gather_into_tensor(out, lead, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    group = _live(mesh, axis, x)
    if group is None:
        return x
    lead = x.movedim(dim, 0).contiguous()
    out = lead.new_empty((lead.shape[0] // mesh.size(axis),) + tuple(lead.shape[1:]))
    dist.reduce_scatter_tensor(out, lead, group=group)
    return out.movedim(0, dim).contiguous()


def _all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    group = _live(mesh, axis, x)
    if group is None:
        return x
    total = x.contiguous().clone()
    dist.all_reduce(total, group=group)
    return total


def _block(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    size, index = mesh.size(axis), mesh.index(axis)
    if x.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} not divisible by axis '{axis}' size "
                         f"{size}")
    block = x.shape[dim] // size
    return x.narrow(dim, index * block, block)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        _live(mesh, axis, x)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh, ctx.axis), None, None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _block(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None, None, None


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS, dim: int = 0) -> torch.Tensor:
    """The ranks' blocks of ``x`` concatenated along ``dim`` in rank order;
    the backward reduce-scatters (sums over ranks, keeps this rank's block)."""
    return _AllGather.apply(x, mesh, axis, dim)


def all_gather_batch(x: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS,
                     tiled: bool = True) -> torch.Tensor:
    """The ranks' batch rows along the leading dim (``tiled=False``: stacked
    on a new leading dim): the global negative pool of the contrastive
    loss."""
    if tiled:
        return all_gather(x, mesh, axis, 0)
    return all_gather(x[None], mesh, axis, 0)


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum over the axis's ranks; the backward is the identity (a
    row-parallel projection's partial products, summed before a
    replicated computation)."""
    return _AllReduce.apply(x, mesh, axis)


def replicated(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x``, the same on every rank, used by each rank for its part of a
    computation: the identity; the backward sums the ranks' partial
    gradients (an all-reduce), so the replicated computation before it
    gets its whole gradient on every rank."""
    return _Replicated.apply(x, mesh, axis)


def shard(x: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS, dim: int = 0) -> torch.Tensor:
    """This rank's block of a replicated ``x`` along ``dim``; the backward
    gathers the blocks' gradients, so the replicated computation before it
    gets its whole gradient on every rank."""
    return _Shard.apply(x, mesh, axis, dim)


def gather_replicated(x: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS,
                      dim: int = 0) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim``, for a replicated
    computation after it; the backward keeps this rank's block of that
    computation's (replicated) gradient."""
    return _GatherReplicated.apply(x, mesh, axis, dim)


def psum(x: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """The sum over the axis's ranks of a value nothing differentiates."""
    with torch.no_grad():
        return _all_reduce(x.detach(), mesh, axis)


def pmean(x: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    with torch.no_grad():
        return psum(x, mesh, axis) / mesh.size(axis)


def average_gradients(params: Iterable[torch.Tensor], mesh: Mesh,
                      axis: str = DATA_AXIS) -> None:
    """Replace each parameter's gradient by its mean over the axis's ranks,
    in place: one all-reduce per (dtype, device) of the gradients flattened
    together.  Every rank must hold gradients for the same parameters."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads or mesh.group(axis) is None:
        return
    size = mesh.size(axis)
    buckets: dict = {}
    for g in grads:
        buckets.setdefault((g.dtype, g.device), []).append(g)
    for bucket in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in bucket])
        flat = _all_reduce(flat, mesh, axis).div_(size)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
