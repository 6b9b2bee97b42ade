"""Data parallelism with losses over the global batch (mirrors the data
axis of seq2seq_vc_tpu/parallel/mesh.py: ``shard_batch``'s wrap-around
padding, ``is_coordinator``).

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
from typing import Any, Dict, Iterable

import numpy as np
import torch
import torch.distributed as dist

from .distributed import rank

_ACTIVE = [False]  # inside data_parallel() with a process group


@contextlib.contextmanager
def data_parallel(on: bool = True):
    """Normalise losses by their global counts while the block runs (when
    ``on`` and a process group exists)."""
    before = _ACTIVE[0]
    _ACTIVE[0] = bool(on) and dist.is_initialized()
    try:
        yield
    finally:
        _ACTIVE[0] = before


def global_count(n: torch.Tensor) -> torch.Tensor:
    """``n`` (a count of this rank's rows) summed over the ranks inside
    ``data_parallel()``; ``n`` itself outside it."""
    if not _ACTIVE[0]:
        return n
    total = n.detach().clone()
    dist.all_reduce(total)
    return total


def global_mean(per_item: torch.Tensor) -> torch.Tensor:
    """The mean over the global batch of a per-row quantity, this rank's
    share of it inside ``data_parallel()`` (its rows' sum over the global
    row count); ``per_item.mean()`` outside it."""
    if not _ACTIVE[0]:
        return per_item.mean()
    n = torch.tensor(float(per_item.shape[0]), device=per_item.device)
    return per_item.sum() / global_count(n)


def all_reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum the ranks' gradients, coalesced into one all-reduce (a parameter
    without a gradient on this rank contributes zeros)."""
    params = [p for p in params if p.requires_grad]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset:offset + n].view_as(g).to(g.dtype)
        offset += n


def broadcast_parameters(module: torch.nn.Module) -> None:
    """Every rank starts from rank 0's parameters and buffers."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, 0)


def shard_batch(batch: Dict[str, Any], rank_: int, world: int) -> Dict[str, Any]:
    """Rank ``rank_``'s rows of a global host batch: the batch padded to a
    multiple of ``world`` by wrap-around repetition (as the JAX package's
    ``shard_batch`` pads a partial batch), then split into ``world``
    contiguous blocks. Arrays and lists with the batch's leading size are
    split; anything else is kept whole."""
    sizes = {len(v) for v in batch.values() if isinstance(v, (np.ndarray, list))}
    B = max(sizes)
    per = -(-B // world)
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


__all__ = ["all_reduce_gradients", "broadcast_parameters", "data_parallel", "global_count",
           "global_mean", "is_coordinator", "rank_seed", "shard_batch"]
