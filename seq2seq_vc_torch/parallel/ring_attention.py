"""Ring attention: attention with the time axis split over the mesh's
``seq`` group (mirrors seq2seq_vc_tpu/parallel/ring_attention.py).

Rank ``i`` of ``n`` holds global positions ``[i * t, (i + 1) * t)`` of the
queries, keys and values. It folds its own K/V block into a running
online-softmax state (max, normaliser, float32 accumulator), then ``n -
1`` times passes its current block to the next rank and folds the one it
receives (``collectives.shift``, whose backward passes the gradients
back round the ring), so every query meets every key once. Masks use
global positions. Autograd differentiates the fold; the blocks' gradients
return to their owners through the shifts' backward.

A ring of one rank (``group=None``) folds its one block: plain attention.
Dropout acts on the unnormalised numerator, the normaliser stays
dropout-free (torch's dropout on the softmax weights); the keep mask comes
from the rank's default generator (JAX's draws are not reproduced).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from . import collectives

_NEG_INF = -1e30


def _ring(scores: Callable, q_shape, k, v, kv_lens, group, causal: bool,
          dropout_rate: float, dtype) -> torch.Tensor:
    """The online-softmax fold over the ring. ``scores(k_blk, kv_pos)``
    gives the scaled float32 (B, H, t_q, t) scores of the local queries
    against a block whose keys sit at global positions ``kv_pos``."""
    n, i = collectives.size(group), collectives.rank(group)
    B, H, t_q, _ = q_shape
    t = k.shape[2]
    dev = k.device
    q_pos = i * t_q + torch.arange(t_q, device=dev)
    keep_p = 1.0 - dropout_rate

    def fold(state, k_blk, v_blk, src):
        m, l, acc = state
        kv_pos = src * t + torch.arange(t, device=dev)
        s = scores(k_blk, kv_pos)
        valid = torch.ones((1, 1, t_q, t), dtype=torch.bool, device=dev)
        if kv_lens is not None:
            valid = valid & (kv_pos[None, :] < kv_lens[:, None].to(dev))[:, None, None, :]
        if causal:
            valid = valid & (kv_pos[None, :] <= q_pos[:, None])[None, None]
        s = torch.where(valid, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        l_new = alpha * l + p.sum(-1, keepdim=True)
        if dropout_rate > 0.0:
            keep = torch.rand(p.shape, device=dev) < keep_p
            p = torch.where(keep, p / keep_p, 0.0)
        pv = torch.matmul(p.to(v_blk.dtype).float(), v_blk.float())
        return m_new, l_new, acc * alpha + pv

    state = (torch.full((B, H, t_q, 1), _NEG_INF, device=dev),
             torch.zeros((B, H, t_q, 1), device=dev),
             torch.zeros((B, H, t_q, v.shape[-1]), device=dev))
    state = fold(state, k, v, i)
    kv, src = (k, v), i
    for _ in range(n - 1):
        kv = collectives.shift(kv, group, 1)  # the block of the rank one back
        src = (src - 1) % n
        state = fold(state, kv[0], kv[1], src)
    _, l, acc = state
    return (acc / torch.where(l == 0.0, 1.0, l)).to(dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_lens: Optional[torch.Tensor] = None, group=None, causal: bool = False,
                   dropout_rate: float = 0.0) -> torch.Tensor:
    """Exact masked attention with the time axis split over ``group``.

    q, k, v: (B, H, t, D) this rank's blocks; kv_lens: (B,) global valid
    key lengths (every rank holds them all); ``causal`` masks in global
    positions. Returns this rank's (B, H, t, D) block. ``dropout_rate``
    (an addition to the JAX function, which has none) drops weights as
    ``ring_rel_attention`` does."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float()

    def scores(k_blk, kv_pos):
        return torch.einsum("bhqd,bhkd->bhqk", qf, k_blk.float()) * scale

    return _ring(scores, q.shape, k, v, kv_lens, group, causal, dropout_rate, q.dtype)


def ring_rel_attention(q_u: torch.Tensor, q_v: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       p: torch.Tensor, kv_lens: Optional[torch.Tensor] = None, group=None,
                       dropout_rate: float = 0.0) -> torch.Tensor:
    """Ring attention with the new-style Transformer-XL relative position
    bias (the conformer's ``RelPositionMultiHeadedAttention``).

    q_u, q_v: (B, H, t, D) this rank's queries plus ``pos_bias_u`` and
    ``pos_bias_v``; k, v: its key/value blocks; p: (H, 2T - 1, D) the
    projected table of the whole sequence (every rank holds it); kv_lens:
    (B,) global valid key lengths. The position scores ``q_v . p`` against
    all 2T - 1 offsets are computed once a rank, and each block gathers its
    columns at ``k_pos - q_pos + T - 1`` (the dense path's rel-shift). A
    sequence padded past the table's T (``nn/conformer.py`` pads the time
    axis to a multiple of the ranks) clamps the offsets of its padded
    positions, whose keys are masked and whose queries are dropped."""
    scale = 1.0 / math.sqrt(q_u.shape[-1])
    n_pos = p.shape[-2]
    centre = (n_pos - 1) // 2
    t = q_u.shape[2]
    q_pos = collectives.rank(group) * t + torch.arange(t, device=q_u.device)
    bd_full = torch.einsum("bhqd,hpd->bhqp", q_v.float(), p.float())
    quf = q_u.float()

    def scores(k_blk, kv_pos):
        ac = torch.einsum("bhqd,bhkd->bhqk", quf, k_blk.float())
        idx = (kv_pos[None, :] - q_pos[:, None] + centre).clamp(0, n_pos - 1)
        bd = torch.take_along_dim(bd_full, idx.expand(*bd_full.shape[:2], *idx.shape), dim=-1)
        return (ac + bd) * scale

    return _ring(scores, q_u.shape, k, v, kv_lens, group, False, dropout_rate, q_u.dtype)


__all__ = ["ring_attention", "ring_rel_attention"]
