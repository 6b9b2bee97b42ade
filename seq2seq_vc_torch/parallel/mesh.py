"""The mesh of process groups, and data parallelism with losses over the
global batch (mirrors seq2seq_vc_tpu/parallel/mesh.py: ``get_mesh``,
``shard_batch``'s wrap-around padding, ``is_coordinator``).

``get_mesh(data, model, seq, pipe)`` lays the world's ranks out as the JAX
package lays its devices: ``arange(world).reshape(data, model, seq,
pipe)``, so rank ``((d * model + m) * seq + s) * pipe + p`` sits at ``(d, m,
s, p)``; each axis of size above 1 becomes a process group of the ranks
that differ only on it (the data axis of a run without model parallelism
is the whole world, even of one rank). The ranks of one model replica
(one ``d``) hold the same rows of every batch, compute the same loss and
draw the same numbers for the same replicated work, so the counts, the
metrics, the gradient sum and the seeds below act over the ``data``
group.

The JAX trainers compute every loss over the global batch: a sum over its
rows divided by a count of the whole sharded batch (valid frames, tokens or
utterances). Here each rank holds its rows (``shard_batch``), and inside
``data_parallel()`` every loss divides its rank's sum by the count summed
over the ranks (``global_count``, ``global_mean``), so the rank losses add
up to the global one and the sum of the rank gradients
(``all_reduce_gradients``, a ``SUM`` all-reduce, where DDP would average) is
the single-process gradient of the same global batch. Outside
``data_parallel()`` (one process, evaluation, decoding) the counts are the
rank's own and nothing is communicated.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import collectives
from .distributed import rank, world_size

AXES = ("data", "model", "seq", "pipe")
_ACTIVE = [False, None]  # inside data_parallel(), and the data group summed over


class Mesh:
    """This rank's place on a ``(data, model, seq, pipe)`` layout of the
    world: ``shape`` and ``coords`` by axis name, and ``groups``, the
    process group of each axis (None for an axis of size 1)."""

    def __init__(self, shape: Dict[str, int], coords: Dict[str, int], groups: Dict[str, Any]):
        self.shape, self.coords, self.groups = shape, coords, groups

    def __repr__(self):
        return "Mesh(" + ", ".join(f"{a}={self.shape[a]}" for a in AXES) + ")"


def get_mesh(data: Optional[int] = None, model: int = 1, seq: int = 1, pipe: int = 1) -> Mesh:
    """The mesh over the world's ranks (mirrors
    seq2seq_vc_tpu/parallel/mesh.py:27-53); ``data`` defaults to
    ``world // (model * seq * pipe)``. Every rank builds every group, in
    the same order."""
    n = world_size()
    if data is None:
        data = n // (model * seq * pipe)
    shape = dict(data=data, model=model, seq=seq, pipe=pipe)
    if data * model * seq * pipe != n:
        raise ValueError(f"mesh {data}x{model}x{seq}x{pipe} != {n} ranks")
    layout = np.arange(n).reshape(data, model, seq, pipe)
    here = np.argwhere(layout == rank())[0]
    coords = dict(zip(AXES, map(int, here)))
    groups: Dict[str, Any] = {}
    for axis, a in zip(AXES, range(4)):
        groups[axis] = None
        if axis == "data" and data == n:  # data parallelism alone: the world,
            groups[axis] = dist.group.WORLD  # one rank's included
            continue
        if shape[axis] == 1:
            continue
        for ranks in np.moveaxis(layout, a, -1).reshape(-1, shape[axis]):
            g = dist.new_group([int(r) for r in ranks])
            if rank() in ranks:
                groups[axis] = g
    return Mesh(shape, coords, groups)


@contextlib.contextmanager
def data_parallel(on: bool = True, group=None):
    """Normalise losses by their counts over ``group`` (the mesh's data
    group; None: this rank's alone) while the block runs (when ``on`` and
    a process group exists)."""
    before = list(_ACTIVE)
    _ACTIVE[:] = [bool(on) and dist.is_initialized(), group]
    try:
        yield
    finally:
        _ACTIVE[:] = before


def global_count(n: torch.Tensor) -> torch.Tensor:
    """``n`` (a count of this rank's rows) summed over the data group
    inside ``data_parallel()``; ``n`` itself outside it."""
    if not _ACTIVE[0]:
        return n
    return collectives.all_reduce(n.detach().clone(), _ACTIVE[1])


def global_mean(per_item: torch.Tensor) -> torch.Tensor:
    """The mean over the global batch of a per-row quantity, this rank's
    share of it inside ``data_parallel()`` (its rows' sum over the global
    row count); ``per_item.mean()`` outside it."""
    if not _ACTIVE[0]:
        return per_item.mean()
    n = torch.tensor(float(per_item.shape[0]), device=per_item.device)
    return per_item.sum() / global_count(n)


def all_reduce_gradients(params: Iterable[torch.nn.Parameter], group) -> None:
    """Sum the gradients over ``group``, coalesced into one all-reduce (a
    parameter without a gradient on this rank contributes zeros)."""
    params = [p for p in params if p.requires_grad]
    if group is None or not params:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    collectives.all_reduce(flat, group)
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset:offset + n].view_as(g).to(g.dtype)
        offset += n


def broadcast_parameters(module: torch.nn.Module) -> None:
    """Every rank of the world starts from rank 0's parameters and buffers."""
    for t in list(module.parameters()) + list(module.buffers()):
        collectives.broadcast_world(t.data, 0)


def shard_batch(batch: Dict[str, Any], rank_: int, world: int,
                extra_multiple: int = 1) -> Dict[str, Any]:
    """Data rank ``rank_``'s rows of a global host batch: the batch padded
    to a multiple of ``world * extra_multiple`` by wrap-around repetition
    (as the JAX package's ``shard_batch`` pads a partial batch;
    ``extra_multiple`` is the pipeline's microbatch count, so that each
    rank's rows split into whole microbatches), then split into ``world``
    contiguous blocks. Arrays and lists with the batch's leading size are
    split; anything else is kept whole."""
    sizes = {len(v) for v in batch.values() if isinstance(v, (np.ndarray, list))}
    B = max(sizes)
    mult = world * max(1, int(extra_multiple))
    per = -(-B // mult) * mult // world
    idx = (np.arange(per * world) % B)[rank_ * per:(rank_ + 1) * per]
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim and len(v) == B:
            out[k] = v[idx]
        elif isinstance(v, list) and len(v) == B:
            out[k] = [v[i] for i in idx]
        else:
            out[k] = v
    return out


def is_coordinator() -> bool:
    """True on the process that logs and writes checkpoints (rank 0)."""
    return rank() == 0


def rank_seed(seed: int, rank_: int) -> int:
    """The seed of rank ``rank_``'s generators: ``seed`` on rank 0 (a run of
    one draws as before), a draw of ``SeedSequence((seed, rank))`` on the
    others."""
    if rank_ == 0:
        return int(seed)
    return int(np.random.SeedSequence((int(seed), int(rank_))).generate_state(1)[0])


@contextlib.contextmanager
def group_rng(group, device, on: bool = True):
    """Draws inside the block that differ between the ranks of ``group``
    (each rank's dropout on its own shard of a split computation), while
    the default generators outside it stay in step over a model replica:
    one seed is drawn from the default CPU generator (the same draw on
    every rank of the replica), the block runs on generators seeded from
    it and the group rank, and the generators are restored afterwards.
    Nothing is drawn when ``group`` is None or ``on`` is false."""
    if group is None or not on:
        yield
        return
    seed = int(torch.randint(0, 2**31 - 1, ()))
    device = torch.device(device)
    cards = [] if device.type != "cuda" else [
        torch.cuda.current_device() if device.index is None else device.index]
    with torch.random.fork_rng(devices=cards):
        torch.manual_seed(rank_seed(seed, collectives.rank(group) + 1))
        yield


__all__ = ["AXES", "Mesh", "all_reduce_gradients", "broadcast_parameters", "data_parallel",
           "get_mesh", "global_count", "global_mean", "group_rng", "is_coordinator", "rank_seed",
           "shard_batch"]
