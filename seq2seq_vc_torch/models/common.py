"""Shared model-level helpers (mirrors seq2seq_vc_tpu/models/common.py)."""

from __future__ import annotations

import torch


def reduce_frames(xs: torch.Tensor, lens: torch.Tensor, factor: int):
    """(B, T, D) -> (B, T//factor, D*factor) frame stacking; lens //= factor.

    T must already be a multiple of ``factor`` (the caller pads).
    """
    if factor <= 1:
        return xs, lens
    B, T, D = xs.shape
    if T % factor:
        raise ValueError(f"pad time dim {T} to a multiple of {factor}")
    return xs.reshape(B, T // factor, D * factor), lens // factor


def conv2d_subsampled_lengths(lens: torch.Tensor) -> torch.Tensor:
    """Length after two VALID stride-2 3x3 convs."""
    return ((lens - 2 + 1) // 2 - 2 + 1) // 2


def nearest_interpolate(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Nearest-neighbour resize along time: (B, T, C) -> (B, out_len, C),
    index floor(out_idx * T_in / T_out) as torch ``F.interpolate``."""
    t_in = x.shape[1]
    idx = torch.arange(out_len, device=x.device) * t_in // out_len
    return x[:, idx, :]
