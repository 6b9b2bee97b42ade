"""Alignment module (mirrors seq2seq_vc_tpu/nn/alignment.py), direct
distance form: the reference's broadcast difference, exact like torch."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .layers import Conv1d


class AlignmentModule(torch.nn.Module):
    def __init__(self, adim: int, odim: Optional[int] = None, device=None, dtype=None):
        super().__init__()
        odim = adim if odim is None else odim
        kw = dict(device=device, dtype=dtype)
        self.t_conv1 = Conv1d(adim, adim, 3, **kw)
        self.t_conv2 = Conv1d(adim, adim, 1, **kw)
        self.f_conv1 = Conv1d(odim, adim, 3, **kw)
        self.f_conv2 = Conv1d(adim, adim, 3, **kw)
        self.f_conv3 = Conv1d(adim, adim, 1, **kw)

    def forward(self, text, feats, x_masks=None):
        """text: (B, T_text, adim); feats: (B, T_feats, odim); x_masks:
        (B, T_text) True at PAD. Returns (B, T_feats, T_text) log-probs."""
        t = self.t_conv2(F.relu(self.t_conv1(text)))
        f = self.f_conv3(F.relu(self.f_conv2(F.relu(self.f_conv1(feats)))))
        d2 = ((f[:, :, None, :] - t[:, None, :, :]) ** 2).sum(-1)
        score = -torch.sqrt(torch.clamp(d2, min=1e-12))
        if x_masks is not None:
            score = score.masked_fill(x_masks[:, None, :], float("-inf"))
        return torch.log_softmax(score, dim=-1)
