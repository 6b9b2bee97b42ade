"""Seq2seq (AR) loss: masked L1 + weighted stop-token BCE (mirrors
seq2seq_vc_tpu/losses/seq2seq.py; the reference's masked_select with mean
reduction is a sum over the valid frames over their count)."""

from __future__ import annotations

import torch

from ..ops.masks import make_non_pad_mask


def bce_with_logits(logits, labels, pos_weight: float = 1.0):
    """Elementwise weighted BCE-with-logits (torch semantics)."""
    softplus_neg = torch.logaddexp(torch.zeros_like(logits), -logits)  # log(1 + e^-x)
    return (1.0 - labels) * logits + (1.0 + (pos_weight - 1.0) * labels) * softplus_neg


class Seq2SeqLoss:
    def __init__(self, bce_pos_weight: float = 10.0):
        self.bce_pos_weight = bce_pos_weight

    def __call__(self, after_outs, before_outs, logits, ys, labels, olens):
        """Returns (l1_loss, bce_loss). after_outs, before_outs, ys: (B,
        Lmax, odim); logits, labels: (B, Lmax); olens: (B,)."""
        mask = make_non_pad_mask(olens, ys.shape[1]).to(ys.dtype)
        m3 = mask[..., None]
        n_feat = torch.clamp(mask.sum() * ys.shape[-1], min=1)
        l1 = ((after_outs - ys).abs() * m3).sum() / n_feat
        l1 = l1 + ((before_outs - ys).abs() * m3).sum() / n_feat
        bce = bce_with_logits(logits, labels.to(logits.dtype), self.bce_pos_weight)
        return l1, (bce * mask).sum() / torch.clamp(mask.sum(), min=1)
