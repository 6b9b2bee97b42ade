"""Flow negative log-likelihood (mirrors seq2seq_vc_tpu/losses/mle.py; no
shipped conf uses it)."""

from __future__ import annotations

import math

import torch

from ..parallel.mesh import global_count


class MLELoss:
    """NLL of z under a standard normal with the flow's log-determinant."""

    def __call__(self, z, logdet, mask):
        """z (B, T, C) latents; logdet (B,); mask (B, T) valid frames."""
        m = mask.to(z.dtype)[..., None]
        n = torch.clamp(global_count(m.sum() * z.shape[-1]), min=1)
        nll = 0.5 * torch.sum(z.square() * m) - torch.sum(logdet)
        return nll / n + 0.5 * math.log(2 * math.pi)
