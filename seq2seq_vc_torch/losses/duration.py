"""Duration predictor losses (mirrors seq2seq_vc_tpu/losses/duration.py).

``DurationPredictorLoss`` holds the deterministic predictor
(``nn/duration_predictor.py``) to the target durations in the log domain.
The stochastic predictor returns its own NLL from the model's forward
pass; its loss is a placeholder for the config name.
"""

from __future__ import annotations

import torch

from ..ops.masks import make_non_pad_mask


class DurationPredictorLoss:
    """MSE in the log domain between predicted log-durations and
    log(d + offset), over the valid tokens."""

    def __init__(self, use_masking: bool = True, offset: float = 1.0, reduction: str = "mean"):
        if reduction != "mean":
            raise ValueError(f"DurationPredictorLoss: reduction {reduction!r} (only 'mean')")
        self.use_masking = use_masking
        self.offset = offset

    def __call__(self, d_outs: torch.Tensor, ds: torch.Tensor, ilens: torch.Tensor):
        if self.use_masking:
            mask = make_non_pad_mask(ilens, ds.shape[1]).to(d_outs.dtype)
        else:
            mask = torch.ones_like(d_outs)
        target = torch.log(ds.float() + self.offset)
        sq = (d_outs - target) ** 2 * mask
        return sq.sum() / torch.clamp(mask.sum(), min=1)


class StochasticDurationPredictorLoss:
    """Placeholder for the config name (the NLL comes from the model)."""

    def __call__(self, *args, **kwargs):
        return None
