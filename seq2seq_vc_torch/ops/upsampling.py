"""Gaussian upsampling (mirrors seq2seq_vc_tpu/ops/upsampling.py:20)."""

from __future__ import annotations

import torch


def gaussian_upsampling(hs, ds, h_masks, d_masks=None, delta: float = 0.1):
    """Upsample token states to frame rate with Gaussian attention.

    Args:
        hs: (B, T_text, D) token hidden states.
        ds: (B, T_text) durations (float or int frames).
        h_masks: (B, T_feats) bool, True at valid output frames; fixes the
            output length.
        d_masks: optional (B, T_text) bool, True at valid tokens.
        delta: temperature.
    Returns:
        (B, T_feats, D) float32 frame-rate states.
    """
    T_feats = h_masks.shape[1]
    ds = ds.float()
    t = torch.arange(T_feats, device=hs.device, dtype=torch.float32)[None, :] * h_masks.float()
    c = torch.cumsum(ds, dim=-1) - ds / 2  # (B, T_text)
    energy = -delta * (t[:, :, None] - c[:, None, :]) ** 2
    if d_masks is not None:
        energy = energy.masked_fill(~d_masks[:, None, :], float("-inf"))
    p_attn = torch.softmax(energy, dim=2)  # (B, T_feats, T_text)
    return torch.einsum("bft,btd->bfd", p_attn, hs.float())
