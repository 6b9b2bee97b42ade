"""Positional encodings (mirror seq2seq_vc_tpu/nn/positional_encoding.py):
the sinusoidal table and the scaled encoding with a learnable alpha (VTN,
:22-31, :75-97), the new-style relative encoding (:34, :100) and the legacy
one (:158-172)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def sinusoidal_pe(length: int, d_model: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(length, d_model) table: sin on even dims, cos on odd. Computed in
    float64 on ``device``, then cast; row t does not depend on ``length``."""
    f64 = dict(dtype=torch.float64, device=device)
    pos = torch.arange(length, **f64)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, **f64) * -(math.log(10000.0) / d_model))
    pe = torch.empty(length, d_model, **f64)
    pe[:, 0::2] = torch.sin(pos * div_term)
    pe[:, 1::2] = torch.cos(pos * div_term)
    return pe.to(dtype)


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
    """Returns (x * sqrt(d), pos_emb (1, 2T-1, d)), each through its own
    dropout draw in ``train()`` mode, as the JAX module."""

    def __init__(self, d_model: int, dropout_rate: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor):
        x = x * math.sqrt(self.d_model)
        pos_emb = relative_pe(x.shape[1], self.d_model, x.dtype, x.device)[None]
        p, on = self.dropout_rate, self.training
        return F.dropout(x, p, on), F.dropout(pos_emb, p, on)


class LegacyRelPositionalEncoding(torch.nn.Module):
    """Legacy relative encoding: returns (x * sqrt(d), pos_emb (1, T, d)),
    the sinusoidal table of the positive positions 0 .. T-1, each through
    its own dropout draw in ``train()`` mode, as the JAX module."""

    def __init__(self, d_model: int, dropout_rate: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor):
        x = x * math.sqrt(self.d_model)
        pos_emb = sinusoidal_pe(x.shape[1], self.d_model, x.dtype, x.device)[None]
        p, on = self.dropout_rate, self.training
        return F.dropout(x, p, on), F.dropout(pos_emb, p, on)


class ScaledPositionalEncoding(torch.nn.Module):
    """x + alpha * PE with a learnable scalar ``alpha``, then dropout in
    ``train()`` mode (VTN, TransformerTTS)."""

    def __init__(self, d_model: int, dropout_rate: float = 0.1, init_alpha: float = 1.0,
                 device=None):
        super().__init__()
        self.d_model = d_model
        self.dropout_rate = dropout_rate
        self.alpha = torch.nn.Parameter(torch.tensor(float(init_alpha), device=device))
        self._table = None  # the last encode_at table, kept for the next step

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pe = sinusoidal_pe(x.shape[1], self.d_model, x.dtype, x.device)
        return F.dropout(x + self.alpha * pe[None], self.dropout_rate, self.training)

    def encode_at(self, x: torch.Tensor, t: int, maxlen: int) -> torch.Tensor:
        """One decode position: x (B, 1, d) at step ``t`` of a table of the
        cache's length ``maxlen``. No dropout (decoding)."""
        key = (maxlen, x.dtype, x.device)
        if self._table is None or self._table[0] != key:
            self._table = (key, sinusoidal_pe(maxlen, self.d_model, x.dtype, x.device))
        return x + self.alpha * self._table[1][t:t + 1][None]
