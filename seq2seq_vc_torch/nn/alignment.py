"""Alignment module (mirrors seq2seq_vc_tpu/nn/alignment.py), direct
distance form: the reference's broadcast difference, exact like torch.

The difference is a (B, T_feats, T_text, C) tensor: 20 GiB in float32 for
the flagship's B 16 at T 960 (C 1536), and autograd would keep two of them.
``pairwise_sq_dist`` builds it a block of frames at a time instead; under
autograd each block is checkpointed, so the backward rebuilds its
difference rather than keep it. Each distance is the same sum over C as in
one pass.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import Conv1d

# the largest difference block built at once, in elements (512 MiB float32)
DIST_BLOCK_ELEMS = 1 << 27


def _sq_dist(f, t):
    return ((f[:, :, None, :] - t[:, None, :, :]) ** 2).sum(-1)


def pairwise_sq_dist(f: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(B, T_f, T_t) squared L2 distances of f (B, T_f, C) and t (B, T_t,
    C) by the direct difference, in blocks of frames whose difference
    stays within ``DIST_BLOCK_ELEMS``."""
    B, T_f, C = f.shape
    rows = max(1, DIST_BLOCK_ELEMS // max(1, B * t.shape[1] * C))
    if rows >= T_f:
        return _sq_dist(f, t)
    track = torch.is_grad_enabled() and (f.requires_grad or t.requires_grad)
    blocks = [
        checkpoint(_sq_dist, f[:, s: s + rows], t, use_reentrant=False) if track
        else _sq_dist(f[:, s: s + rows], t)
        for s in range(0, T_f, rows)
    ]
    return torch.cat(blocks, dim=1)


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
        score = -torch.sqrt(torch.clamp(pairwise_sq_dist(f, t), min=1e-12))
        if x_masks is not None:
            score = score.masked_fill(x_masks[:, None, :], float("-inf"))
        return torch.log_softmax(score, dim=-1)
