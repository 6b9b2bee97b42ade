"""Masked L2 between the injected and the predicted diffusion noise
(mirrors seq2seq_vc_tpu/losses/diffsinger_l2.py): the sum over the valid
frames over the count of valid values."""

from __future__ import annotations

import torch

from ..ops.masks import make_non_pad_mask
from ..parallel.mesh import global_count


class DiffSingerL2Loss:
    def __init__(self, use_masking: bool = True, reduction: str = "mean"):
        if reduction != "mean":
            raise ValueError(f"DiffSingerL2Loss: reduction {reduction!r} (only 'mean')")
        self.use_masking = use_masking

    def __call__(self, noise, x_recon, olens):
        """noise, x_recon (B, T, D); olens (B,) valid frame counts on the
        same (reduced) time grid."""
        if self.use_masking:
            mask = make_non_pad_mask(olens, noise.shape[1]).to(noise.dtype)[..., None]
        else:
            mask = torch.ones_like(noise[..., :1])
        n = torch.clamp(global_count(mask.sum() * noise.shape[-1]), min=1)
        return ((x_recon - noise).square() * mask).sum() / n
