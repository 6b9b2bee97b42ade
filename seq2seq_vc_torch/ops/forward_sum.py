"""CTC forward-sum alignment loss and its beta-binomial prior (mirrors
seq2seq_vc_tpu/ops/forward_sum.py).

``forward_sum_loss`` runs PyTorch's native CTC (``F.ctc_loss``) on the
blank-prepended attention scores. Its backward returns ``exp(lp) -
posterior``, the gradient with respect to the logits of a log-softmax,
and assigns it to the scores it was given. The scores here are not
normalised (log-softmax attention plus the prior), so that differs from
the true input gradient by ``exp(lp) / target_len`` per valid cell: the
reference's training gradient, which the JAX package reproduces as
``grad_semantics="torch"`` and the port gets from the same CTC backward.

The targets go to the device as int64 padded rows, so that PyTorch takes
its native CTC and not cuDNN's (taken for int32 concatenated targets on
the CPU), which may treat its input as normalised.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.stats import betabinom

_NEG_INF = -1e30

_prior_cache: Dict[Tuple[int, int, float], np.ndarray] = {}


def beta_binomial_prior(
    text_lengths: np.ndarray,
    feats_lengths: np.ndarray,
    t_text_max: int,
    t_feats_max: int,
    w: float = 1.0,
) -> np.ndarray:
    """Batched (B, T_feats_max, T_text_max) log-prior, padded with -1e30.

    Per item: ``betabinom.logpmf(k, N, w*t, w*(T-t+1))`` over frame t and
    token k (a host-side numpy copy of the JAX package's function; cached
    per length pair).
    """
    B = len(text_lengths)
    out = np.full((B, t_feats_max, t_text_max), _NEG_INF, dtype=np.float32)
    for b in range(B):
        T = int(feats_lengths[b])
        N = int(text_lengths[b])
        key = (T, N, w)
        if key not in _prior_cache:
            alpha = w * np.arange(1, T + 1, dtype=float)  # (T,)
            beta = w * (T - alpha + 1.0)
            k = np.arange(N)[:, None]  # (N, 1)
            _prior_cache[key] = betabinom.logpmf(k, N, alpha, beta).T.astype(np.float32)
        out[b, :T, :N] = _prior_cache[key]
    return out


def forward_sum_loss(
    log_p_attn: torch.Tensor,
    ilens: torch.Tensor,
    olens: torch.Tensor,
    blank_prob: float = math.exp(-1),
) -> torch.Tensor:
    """Batched forward-sum loss.

    Args:
        log_p_attn: (B, T_feats, T_text) attention log-probs, prior added.
        ilens: (B,) text lengths (the CTC targets are tokens 1..N).
        olens: (B,) feature lengths.
        blank_prob: CTC blank score.
        Both lengths are tensors or both host sequences of ints; host
        lengths spare CUDA's CTC a copy of them back to the host.
    Returns:
        Scalar: the mean over the batch of each item's loss divided by its
        text length, with non-finite items and their gradients zeroed.
    """
    B, t_feats, t_text = log_p_attn.shape
    blank = torch.full((B, t_feats, 1), math.log(blank_prob),
                       dtype=log_p_attn.dtype, device=log_p_attn.device)
    # the padded tokens' -inf becomes -1e30: PyTorch's CTC backward forms
    # lp - lp at every class, and -inf there would give NaN gradients (the
    # clamp passes no gradient to them; the JAX package gives them none)
    scores = torch.clamp(log_p_attn, min=_NEG_INF)
    lp = torch.cat([blank, scores], dim=2).transpose(0, 1)  # (T_feats, B, 1+T_text)
    targets = torch.arange(1, t_text + 1, device=log_p_attn.device, dtype=torch.int64)
    if isinstance(ilens, torch.Tensor):
        ilens, olens = ilens.to(torch.int64), olens.to(torch.int64)
    else:
        ilens, olens = tuple(int(n) for n in ilens), tuple(int(n) for n in olens)
    return F.ctc_loss(
        lp, targets.expand(B, t_text).contiguous(), olens, ilens,
        blank=0, reduction="mean", zero_infinity=True,
    )
