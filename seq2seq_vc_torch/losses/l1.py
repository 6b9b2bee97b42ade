"""Masked L1 loss for NAR models (mirrors seq2seq_vc_tpu/losses/l1.py)."""

from __future__ import annotations

import torch

from ..ops.masks import make_non_pad_mask


class L1Loss:
    def __init__(self, use_masking: bool = True, reduction: str = "mean"):
        if reduction != "mean":
            raise ValueError(f"L1Loss: reduction {reduction!r} (only 'mean')")
        self.use_masking = use_masking

    def __call__(self, after_outs, before_outs, ys, olens):
        """Mean absolute error over the valid frames of ``before_outs`` and,
        when given, of ``after_outs``, each normalised by the same count."""
        if self.use_masking:
            mask = make_non_pad_mask(olens, ys.shape[1]).to(ys.dtype)[..., None]
        else:
            mask = torch.ones_like(ys[..., :1])
        n = torch.clamp(mask.sum() * ys.shape[-1], min=1)
        loss = ((before_outs - ys).abs() * mask).sum() / n
        if after_outs is not None:
            loss = loss + ((after_outs - ys).abs() * mask).sum() / n
        return loss
