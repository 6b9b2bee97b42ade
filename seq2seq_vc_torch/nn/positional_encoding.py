"""New-style relative positional encoding (mirrors
seq2seq_vc_tpu/nn/positional_encoding.py:34,100)."""

from __future__ import annotations

import math

import torch


def relative_pe(length: int, d_model: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(2*length - 1, d_model) table for positions length-1 .. -(length-1).

    Row 0 is the most positive relative position, the centre is 0, the last
    row the most negative (espnet RelPositionalEncoding order). Computed in
    float64 on ``device``, then cast.
    """
    f64 = dict(dtype=torch.float64, device=device)
    pos = torch.arange(length - 1, -length, -1, **f64)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, **f64) * -(math.log(10000.0) / d_model))
    pe = torch.empty(2 * length - 1, d_model, **f64)
    pe[:, 0::2] = torch.sin(pos * div_term)
    pe[:, 1::2] = torch.cos(pos * div_term)
    return pe.to(dtype)


class RelPositionalEncoding(torch.nn.Module):
    """Returns (x * sqrt(d), pos_emb (1, 2T-1, d)). Inference: no dropout."""

    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model

    def forward(self, x: torch.Tensor):
        x = x * math.sqrt(self.d_model)
        pos_emb = relative_pe(x.shape[1], self.d_model, x.dtype, x.device)[None]
        return x, pos_emb
