"""Transformer building blocks the conformer uses (mirrors
seq2seq_vc_tpu/nn/transformer.py): LN_EPS, the position-wise feed-forward,
the positional-encoding factory and Conv2dSubsampling."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Linear
from .positional_encoding import RelPositionalEncoding

LN_EPS = 1e-12  # the reference layer_norm.py uses eps=1e-12


class PositionwiseFeedForward(torch.nn.Module):
    """w_2(dropout(act(w_1(x)))); the dropout acts in ``train()`` mode."""

    def __init__(self, idim: int, hidden_units: int, dropout_rate: float = 0.1,
                 activation: str = "relu", compute_dtype=None, device=None, dtype=None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, device=device, dtype=dtype)
        self.w_1 = Linear(idim, hidden_units, **kw)
        self.w_2 = Linear(hidden_units, idim, **kw)
        self.act = F.silu if activation == "swish" else F.relu
        self.dropout_rate = dropout_rate

    def forward(self, x):
        h = F.dropout(self.act(self.w_1(x)), self.dropout_rate, self.training)
        return self.w_2(h)


def _positionwise(kind: str, idim: int, linear_units: int, dropout_rate: float = 0.1,
                  compute_dtype=None, activation: str = "relu", device=None, dtype=None):
    if kind == "linear":
        return PositionwiseFeedForward(
            idim, linear_units, dropout_rate, activation, compute_dtype,
            device=device, dtype=dtype,
        )
    raise NotImplementedError(f"positionwise_layer_type {kind!r} is not ported yet")


def _make_pos_enc(kind: str, d: int, dropout_rate: float = 0.1):
    if kind == "rel_pos":
        return RelPositionalEncoding(d, dropout_rate)
    raise NotImplementedError(f"pos_enc type {kind!r} is not ported yet")


class Conv2dSubsampling(torch.nn.Module):
    """Two stride-2 3x3 convs over (time, freq): 1/4 time reduction.

    Reference layout (``conv.0``, ``conv.2``, bare ``out`` Linear over the
    channel-major flattening), as the reference builds it with
    use_pos_enc=False for AAS-VC's duration-predictor projection.
    """

    def __init__(self, idim: int, odim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv = torch.nn.Sequential(
            torch.nn.Conv2d(1, odim, 3, 2, **kw), torch.nn.ReLU(),
            torch.nn.Conv2d(odim, odim, 3, 2, **kw), torch.nn.ReLU(),
        )
        self.out = torch.nn.Linear(odim * (((idim - 1) // 2 - 1) // 2), odim, **kw)

    def forward(self, x, mask=None):
        h = self.conv(x.float()[:, None])  # (B, C, T', F')
        b, c, t, f = h.shape
        h = self.out(h.transpose(1, 2).reshape(b, t, c * f))
        if mask is not None:
            mask = mask[:, :-2:2][:, :-2:2]
        return h, mask
