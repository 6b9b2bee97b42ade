"""Padding, causal and decoder target masks (mirrors
seq2seq_vc_tpu/ops/masks.py)."""

from __future__ import annotations

import torch


def make_pad_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """(B, maxlen) bool mask, True where position >= length (i.e. padding)."""
    pos = torch.arange(maxlen, device=lengths.device)[None, :]
    return pos >= lengths[:, None]


def make_non_pad_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """(B, maxlen) bool mask, True at valid (non-pad) positions."""
    return ~make_pad_mask(lengths, maxlen)


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """(size, size) bool causal mask, True where attention is allowed."""
    return torch.ones((size, size), dtype=torch.bool, device=device).tril()


def target_mask(olens: torch.Tensor, maxlen: int) -> torch.Tensor:
    """(B, maxlen, maxlen) decoder self-attention mask: causal AND key
    non-pad. Query rows are NOT masked: padded rows still attend the valid
    prefix, as in the reference, so the postnet's convolutions over the
    padded tail see the same values as the JAX package's."""
    non_pad = make_non_pad_mask(olens, maxlen)
    return non_pad[:, None, :] & subsequent_mask(maxlen, olens.device)[None]
