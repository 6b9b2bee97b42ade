"""Gaussian upsampling and the hard length regulator (mirror
seq2seq_vc_tpu/ops/upsampling.py:20, :49)."""

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


def length_regulator(hs, ds, t_feats: int, pad_value: float = 0.0):
    """Hard repeat-interleave upsampling with a fixed output length.

    Frame t takes the token whose cumulative-duration interval holds it,
    ``idx[t] = #{i : cumsum(ds)[i] <= t}`` (a right-sided search in the
    non-decreasing cumulative sums), clamped to the last token; frames past
    the total duration get ``pad_value``.

    Args:
        hs: (B, T_text, D).
        ds: (B, T_text) non-negative integer durations.
        t_feats: output frame count.
    Returns:
        (B, t_feats, D) expanded states.
    """
    cum = torch.cumsum(ds.long(), dim=-1)  # (B, T_text)
    t = torch.arange(t_feats, device=hs.device)
    idx = torch.searchsorted(cum, t.expand(cum.shape[0], t_feats).contiguous(), right=True)
    idx = torch.clamp(idx, max=hs.shape[1] - 1)
    out = torch.gather(hs, 1, idx[..., None].expand(-1, -1, hs.shape[2]))
    valid = t[None, :] < cum[:, -1:]
    return torch.where(valid[..., None], out, torch.as_tensor(pad_value, dtype=hs.dtype))
