"""The collectives of model parallelism, plain and differentiable.

Every collective a rank issues goes through this module, over one process
group of the mesh (``parallel/mesh.py``). ``group=None`` stands for an axis
of size 1: each function then returns its input and communicates nothing
(``torch.distributed``'s own ``None``, the whole world, is never meant).

The differentiable ones pair a forward with the backward that the
surrounding computation needs (Megatron's f and g, and the sequence
split):

- ``copy_to``: identity forward, gradients summed over the group backward
  (a replicated input that each rank consumes only in part);
- ``reduce_from``: sum forward, identity backward (partial results whose
  sum every rank then uses in the same replicated computation, so each
  rank already holds the whole gradient);
- ``sum_over``: sum forward and backward (statistics of a sharded axis that
  each rank then applies to its own shard);
- ``split``/``gather``: a rank's block of a replicated tensor and back;
- ``shift``: every rank sends to the rank ``step`` places on and receives
  from the rank ``step`` places back (JAX's ``ppermute`` on a ring); its
  backward is the reverse shift.

``gloo`` moves host tensors: on a ``gloo`` group a tensor on the card is
copied to the host for the collective and back (logged once a process), as
when several ranks share one card, where NCCL refuses to run. On an NCCL
group nothing is staged.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

_STAGED_LOGGED = [False]


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(t: torch.Tensor, group) -> bool:
    if not (t.is_cuda and dist.get_backend(group) == "gloo"):
        return False
    if not _STAGED_LOGGED[0]:
        _STAGED_LOGGED[0] = True
        logging.info("gloo group on CUDA tensors: each collective is staged through host "
                     "memory (the computation stays on the card)")
    return True


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    if group is None:
        return t
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group-rank order."""
    if group is None:
        return t
    src = t.contiguous().cpu() if _staged(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(t.device)


def broadcast_world(t: torch.Tensor, src: int = 0) -> None:
    """``t`` from global rank ``src`` to every rank of the world, in place."""
    if _staged(t, dist.group.WORLD):
        host = t.cpu()
        dist.broadcast(host, src)
        t.copy_(host)
    else:
        dist.broadcast(t, src)


def sendrecv(tensors: Sequence[torch.Tensor], group, step: int) -> List[torch.Tensor]:
    """Send each of ``tensors`` to the group rank ``step`` places on and
    receive the same shapes from the rank ``step`` places back."""
    n, r = size(group), rank(group)
    dst = dist.get_global_rank(group, (r + step) % n)
    src = dist.get_global_rank(group, (r - step) % n)
    staged = _staged(tensors[0], group)
    outs = [t.contiguous().cpu() if staged else t.contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in outs]
    ops = []
    for s, o in zip(outs, recv):
        ops += [dist.P2POp(dist.isend, s, dst, group), dist.P2POp(dist.irecv, o, src, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [o.to(t.device) for o, t in zip(recv, tensors)]


def block(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` (not differentiable)."""
    if group is None:
        return t
    n = t.shape[dim] // size(group)
    return t.narrow(dim, rank(group) * n, n)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return block(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return block(g, ctx.group, ctx.dim).contiguous(), None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, step, *xs):
        ctx.group, ctx.step = group, step
        return tuple(sendrecv(xs, group, step))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *sendrecv(gs, ctx.group, -ctx.step))


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` (in float32, returned in ``x``'s dtype)."""
    if group is None:
        return x
    return _ReduceFrom.apply(x.float(), group).to(x.dtype)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumOver.apply(x, group)


def split(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group is None else _Split.apply(x, group, dim)


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group is None else _Gather.apply(x, group, dim)


def shift(xs: Sequence[torch.Tensor], group, step: int = 1) -> List[torch.Tensor]:
    """Each rank's ``xs`` from the rank ``step`` places back on the ring."""
    if group is None:
        return list(xs)
    return list(_Shift.apply(group, step, *xs))


def all_gather_object(obj, group) -> list:
    """The ranks' ``obj`` in group-rank order (checkpoints: host tensors)."""
    if group is None:
        return [obj]
    out: List[Optional[object]] = [None] * size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


__all__ = ["all_gather", "all_gather_object", "all_reduce", "block", "broadcast_world", "copy_to",
           "gather", "rank", "reduce_from", "sendrecv", "shift", "size", "split", "sum_over"]
