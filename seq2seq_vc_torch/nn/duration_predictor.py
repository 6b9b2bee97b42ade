"""Deterministic duration predictor (mirrors
seq2seq_vc_tpu/nn/duration_predictor.py:19).

(Conv1d "SAME" -> ReLU -> LayerNorm (eps 1e-12) -> dropout) x N, then a
Linear head. Training output is log-domain; inference returns
``clamp(round(exp(x) - offset), min=0)``. Pad positions are zeroed in both.
Names follow the reference torch code: ``conv.N.0`` is the conv,
``conv.N.2`` the norm, ``linear`` the head. The stochastic variant is
``nn/flows.StochasticDurationPredictor``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .layers import Conv1d, LayerNorm, Linear


class DurationPredictor(torch.nn.Module):
    def __init__(self, idim: int, n_layers: int = 2, n_chans: int = 384, kernel_size: int = 3,
                 dropout_rate: float = 0.1, offset: float = 1.0, device=None, dtype=None):
        super().__init__()
        if kernel_size % 2 == 0:
            raise ValueError("duration predictor kernel size must be odd (SAME padding)")
        kw = dict(device=device, dtype=dtype)
        self.offset = offset
        self.conv = torch.nn.ModuleList(
            torch.nn.Sequential(
                Conv1d(idim if i == 0 else n_chans, n_chans, kernel_size, **kw),
                torch.nn.ReLU(),
                LayerNorm(n_chans, 1e-12, **kw),
                torch.nn.Dropout(dropout_rate),
            )
            for i in range(n_layers)
        )
        self.linear = Linear(n_chans, 1, **kw)

    def forward(self, xs: torch.Tensor, x_masks: Optional[torch.Tensor] = None,
                is_inference: bool = False) -> torch.Tensor:
        """xs: (B, T, idim); x_masks: (B, T) True at PAD positions (the
        reference's convention here). Returns (B, T) log-durations, or with
        ``is_inference`` rounded durations."""
        h = xs
        for layer in self.conv:
            h = layer(h)
        h = self.linear(h)[..., 0]
        if is_inference:
            h = torch.clamp(torch.round(torch.exp(h) - self.offset), min=0.0)
        if x_masks is not None:
            h = h.masked_fill(x_masks, 0.0)
        return h
