"""Padding masks (mirrors seq2seq_vc_tpu/ops/masks.py)."""

from __future__ import annotations

import torch


def make_pad_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """(B, maxlen) bool mask, True where position >= length (i.e. padding)."""
    pos = torch.arange(maxlen, device=lengths.device)[None, :]
    return pos >= lengths[:, None]


def make_non_pad_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """(B, maxlen) bool mask, True at valid (non-pad) positions."""
    return ~make_pad_mask(lengths, maxlen)
