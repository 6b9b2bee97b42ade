"""Dense multi-head attention core (mirrors seq2seq_vc_tpu/ops/attention.py).

Masked scores get a large negative fill before the softmax and exact zeros
after it, so a masked key carries no weight even in a row with no live key;
the softmax map can be returned for guided-attention losses.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

MASK_FILL = -1e9


def scaled_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None, return_weights: bool = False):
    """softmax(q k^T / sqrt(D)) v.

    Args:
        q: (B, H, Tq, D); k, v: (B, H, Tk, D).
        mask: bool, broadcastable to (B, H, Tq, Tk), True where a query may
            attend a key.
    Returns:
        (B, H, Tq, D) context in v's dtype and, with ``return_weights``, the
        float32 (B, H, Tq, Tk) weights. Scores and the softmax are float32;
        the weights times v run in v's dtype (float32 accumulation).
    """
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores.masked_fill(~mask, MASK_FILL)
    attn = torch.softmax(scores, dim=-1)
    if mask is not None:
        attn = attn.masked_fill(~mask, 0.0)
    out = torch.matmul(attn.to(v.dtype), v)
    return (out, attn) if return_weights else out
