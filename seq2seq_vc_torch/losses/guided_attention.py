"""Guided (diagonal) attention losses (mirrors
seq2seq_vc_tpu/losses/guided_attention.py): attention mass far from the
diagonal is penalised with the weight ``1 - exp(-(o/olen - i/ilen)^2 / (2
sigma^2))``, averaged over the valid (output, input) cells.

As in the JAX package, each valid cell counts once per head in the
denominator, and the lengths are clamped at 1 in the weights. The heads are
summed before the weighting (the weight does not depend on the head), so a
(B, L, H, T_out, T_in) view of a stack of maps is never copied.
"""

from __future__ import annotations

import math

import torch

from ..ops.masks import make_non_pad_mask
from ..parallel.mesh import global_count


def _guided_attention_weights(ilens, olens, max_ilen: int, max_olen: int, sigma: float):
    """(B, max_olen, max_ilen) diagonal-distance penalty weights."""
    dev = ilens.device
    i = torch.arange(max_ilen, device=dev, dtype=torch.float32)[None, None, :]
    o = torch.arange(max_olen, device=dev, dtype=torch.float32)[None, :, None]
    ilens_f = ilens.float().clamp_min(1)[:, None, None]
    olens_f = olens.float().clamp_min(1)[:, None, None]
    d = i / ilens_f - o / olens_f
    return 1.0 - torch.exp(-(d ** 2) / (2 * sigma ** 2))


class GuidedAttentionLoss:
    def __init__(self, sigma: float = 0.4, alpha: float = 1.0, reset_always: bool = True):
        self.sigma = sigma
        self.alpha = alpha

    def _loss(self, att_ws, ilens, olens):
        """att_ws: (B, *heads, T_out, T_in), any number of head axes."""
        max_olen, max_ilen = att_ws.shape[-2], att_ws.shape[-1]
        w = _guided_attention_weights(ilens, olens, max_ilen, max_olen, self.sigma)
        valid = (make_non_pad_mask(olens, max_olen)[:, :, None]
                 & make_non_pad_mask(ilens, max_ilen)[:, None, :])
        heads = tuple(range(1, att_ws.dim() - 2))
        summed = att_ws.float().sum(dim=heads) if heads else att_ws.float()
        num = (summed * torch.where(valid, w, 0.0)).sum()
        den = global_count(valid.sum() * math.prod(att_ws.shape[1:-2])).clamp_min(1)
        return self.alpha * num / den

    def __call__(self, att_ws, ilens, olens):
        """att_ws: (B, T_out, T_in)."""
        return self._loss(att_ws, ilens, olens)


class GuidedMultiHeadAttentionLoss(GuidedAttentionLoss):
    def __call__(self, att_ws, ilens, olens):
        """att_ws: (B, H, T_out, T_in), or (B, L, H, T_out, T_in): every
        axis between the batch and the last two is a head axis."""
        return self._loss(att_ws, ilens, olens)
