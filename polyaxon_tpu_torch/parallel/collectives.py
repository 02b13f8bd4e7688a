"""The collectives of the sharded strategies, as autograd functions.

The reference names no collective: XLA inserts them from the shardings
(``parallel/axes.py``).  Each rank of the port holds its shards and calls
them itself:

- :func:`gather_along`: all-gather forward, reduce-scatter backward; the
  fsdp gather of a weight at its use, whose backward sums the ranks' grads
  into each rank's shard;
- :func:`copy_to_group` (identity forward, all-reduce backward) and
  :func:`reduce_from_group` (all-reduce forward, identity backward):
  Megatron's f and g, around tensor-parallel products;
- :func:`gather_from_group`: all-gather forward, this rank's slice
  backward; a tensor-parallel output that every rank then uses whole;
- :func:`all_to_all_swap`: Ulysses' swap of a sharded dimension for
  another; its backward is the reverse swap;
- :func:`sum_over_group`: all-reduce forward and backward; a sum every
  rank uses as its own term of one objective (MoE's global balance
  statistics, whose ranks' losses the train step weighs by their counts);
- :func:`send_to_next`: the pipeline's stage hop, rank s to s + 1 (rank 0
  gets zeros); its backward is the reverse hop;
- :func:`broadcast_from`: one rank's tensor on every rank of a group, no
  autograd (the stage-owned decode's logits, from the last stage).

Each is the identity for a group of one (None).  They call the list forms
(``dist.all_gather``, ``dist.reduce_scatter``, ``dist.all_reduce``,
``dist.all_to_all``): the ``_tensor`` / ``_single`` forms are not methods
of a bare ``ProcessGroupGloo``, the group of thread ranks on the CPU.  On a
gloo group the swap is an all-gather (:func:`_swap`); NCCL takes every call
directly.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def group_size(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else group.size()


def all_gather_cat(x: torch.Tensor, dim: int, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The group's shards of ``x`` concatenated along ``dim``, in rank order."""
    if group_size(group) == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size())]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group: dist.ProcessGroup) -> torch.Tensor:
    """The sum over the group of each rank's ``x``, this rank's block along ``dim``."""
    parts = [p.contiguous() for p in x.chunk(group.size(), dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def _all_reduce(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _swap(x: torch.Tensor, split_dim: int, cat_dim: int, group: dist.ProcessGroup) -> torch.Tensor:
    """Send block j of ``x`` along ``split_dim`` to rank j; concatenate what
    arrives along ``cat_dim`` in rank order."""
    n = group.size()
    if group.name() == "gloo":
        # Gloo's list-form all-to-all raises "Backend gloo does not support
        # alltoall" in the torch of the card's machine (2.11), for CPU and
        # CUDA tensors alike.  Each rank gathers every rank's whole x and
        # keeps its own block of each: n times the bytes of an all-to-all,
        # in a form every version has.
        got = [whole.chunk(n, dim=split_dim)[group.rank()]
               for whole in all_gather_cat(x, 0, group).chunk(n, dim=0)]
    else:
        parts: List[torch.Tensor] = [p.contiguous() for p in x.chunk(n, dim=split_dim)]
        got = [torch.empty_like(parts[0]) for _ in range(n)]
        dist.all_to_all(got, parts, group=group)
    return torch.cat(got, dim=cat_dim)


def hop(x: torch.Tensor, group: dist.ProcessGroup, reverse: bool = False) -> torch.Tensor:
    """Send ``x`` to rank r + 1 of ``group`` and return what rank r − 1 sent
    (``reverse``: to r − 1, from r + 1); the end with no sender gets zeros,
    the end with no receiver sends nothing: the reference's ``lax.ppermute``
    along the stages (``polyaxon_tpu/parallel/pipeline.py:124``) without its
    wrap-around, whose payload stage 0 discards.  Every rank of the
    group calls it together: the send and the receive go out as one
    ``batch_isend_irecv``, so no rank blocks in a send its peer has not
    met with a receive."""
    n, r = group.size(), group.rank()
    step = -1 if reverse else 1
    dst, src = r + step, r - step
    # Gloo's send and receive take no CUDA tensor: on the card's torch 2.11
    # every form (send/recv, isend/irecv, batch_isend_irecv) fails with
    # "writev ...: Bad address" (tools/gloo_probe.py), as gloo writes the
    # device pointer to its socket.  On a gloo group a CUDA tensor goes
    # through a host copy each way: the bytes of the hop, no more.  NCCL
    # takes the tensor itself.
    staged = x.is_cuda and group.name() == "gloo"
    sent = (x.cpu() if staged else x).contiguous()
    got = torch.zeros_like(sent)
    ops = []
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, sent, group=group, group_peer=dst))
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, got, group=group, group_peer=src))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return got.to(x.device) if staged else got


def broadcast_from(x: torch.Tensor, group: Optional[dist.ProcessGroup], src: int) -> torch.Tensor:
    """Rank ``src`` of ``group``'s ``x`` on every rank of it (the others pass
    a buffer of its shape and dtype, which is not read); no autograd.  The
    stage-owned decode's logits, which the last stage computes and every
    stage picks from.  On a gloo group a CUDA tensor goes through a host
    copy each way, as :func:`hop`'s; the identity for a group of one."""
    if group_size(group) == 1:
        return x
    staged = x.is_cuda and group.name() == "gloo"
    out = (x.cpu() if staged else x).contiguous().clone()
    dist.broadcast(out, group=group, group_src=src)
    return out.to(x.device) if staged else out


class _SendToNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return hop(x, group)

    @staticmethod
    def backward(ctx, grad):
        return hop(grad, ctx.group, reverse=True), None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.dim, ctx.group), None, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        n, r = ctx.group.size(), ctx.group.rank()
        return grad.chunk(n, dim=ctx.dim)[r].contiguous(), None, None


class _AllToAllSwap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, group):
        ctx.split_dim, ctx.cat_dim, ctx.group = split_dim, cat_dim, group
        return _swap(x, split_dim, cat_dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _swap(grad, ctx.cat_dim, ctx.split_dim, ctx.group), None, None, None


def gather_along(x: torch.Tensor, dim: int, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """All ranks' shards of ``x`` along ``dim``; the backward reduce-scatters
    (each rank's grad of the whole, summed, cut to its shard)."""
    return x if group_size(group) == 1 else _GatherAlong.apply(x, dim, group)


def copy_to_group(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """``x`` as it is; the backward sums the group's grads (Megatron's f)."""
    return x if group_size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The sum of the group's ``x``; the backward passes the grad through
    (Megatron's g)."""
    return x if group_size(group) == 1 else _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, dim: int,
                      group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """All ranks' blocks of ``x`` along ``dim``, used whole by every rank;
    the backward keeps this rank's block of the grad."""
    return x if group_size(group) == 1 else _GatherFromGroup.apply(x, dim, group)


def all_to_all_swap(x: torch.Tensor, split_dim: int, cat_dim: int,
                    group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Split ``x`` along ``split_dim`` over the group's ranks and gather
    along ``cat_dim``: ``[B, T/n, H, d]`` → ``[B, T, H/n, d]`` with
    ``split_dim=2, cat_dim=1`` (``lax.all_to_all(..., tiled=True)``); the
    backward is the reverse swap."""
    if group_size(group) == 1:
        return x
    return _AllToAllSwap.apply(x, split_dim, cat_dim, group)


def sum_over_group(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The sum of the group's ``x``; the backward sums the group's grads.
    The rule for a sum that each rank puts into its own loss: rank r's
    share of the sum gets the cotangents of every rank's use of it."""
    return x if group_size(group) == 1 else _SumOverGroup.apply(x, group)


def send_to_next(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """What rank r − 1 of ``group`` sent (zeros on rank 0), this rank's
    ``x`` going to rank r + 1 (the reference's ``lax.ppermute`` along the
    stages, ``polyaxon_tpu/parallel/pipeline.py:124``); the backward is the
    reverse hop.  The identity for a group of one."""
    return x if group_size(group) == 1 else _SendToNext.apply(x, group)
