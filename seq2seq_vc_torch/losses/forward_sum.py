"""Forward-sum alignment loss wrapper (mirrors
seq2seq_vc_tpu/losses/forward_sum.py): adds the host-computed, cached
beta-binomial prior to the attention log-probs and runs the CTC
forward-sum of ``ops/forward_sum.py``."""

from __future__ import annotations

import math

import torch

from ..ops.forward_sum import beta_binomial_prior, forward_sum_loss


class ForwardSumLoss:
    def __call__(self, log_p_attn, ilens, olens, blank_prob: float = math.exp(-1)):
        """log_p_attn: (B, T_feats, T_text); ilens/olens: (B,) lengths."""
        _, t_feats, t_text = log_p_attn.shape
        prior = beta_binomial_prior(ilens.cpu().numpy(), olens.cpu().numpy(), t_text, t_feats)
        biased = log_p_attn + torch.from_numpy(prior).to(log_p_attn.device)
        return forward_sum_loss(biased, ilens, olens, blank_prob=blank_prob)
