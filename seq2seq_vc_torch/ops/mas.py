"""Monotonic alignment search (mirrors seq2seq_vc_tpu/ops/mas.py).

A loop over mel frames in plain PyTorch, batched over items. It runs on
every training step (``AASVC.forward``) and in ``AASVC.inference``'s debug
branch with a ground-truth target. Same DP and tie-break as the JAX
package: ``Q[i-1] >= Q[i]`` prefers the diagonal. The search reads the
log-probs detached: the durations carry no gradient, while
``viterbi_decode``'s binarisation loss gathers from the live tensor, so its
gradient reaches the alignment module (seq2seq_vc_tpu/ops/mas.py:90-118).
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def monotonic_alignment_search(log_p_attn, text_lengths, feats_lengths):
    """(B, T_feats, T_text) log-probs -> (B, T_feats) int64 text index per frame."""
    B, T_feats, T_text = log_p_attn.shape
    lp = log_p_attn.detach().float()
    text_mask = torch.arange(T_text, device=lp.device)[None, :] < text_lengths[:, None]
    lp = torch.where(text_mask[:, None, :], lp, _NEG_INF)

    q = torch.full((B, T_feats, T_text), _NEG_INF, device=lp.device)
    q[:, 0, 0] = lp[:, 0, 0]
    neg = torch.full((B, 1), _NEG_INF, device=lp.device)
    for j in range(1, T_feats):
        prev = q[:, j - 1]
        shifted = torch.cat([neg, prev[:, :-1]], dim=1)
        q[:, j] = torch.maximum(shifted, prev) + lp[:, j]

    last = (text_lengths - 1).long()
    path = torch.empty((B, T_feats), dtype=torch.long, device=lp.device)
    path[:, T_feats - 1] = last
    a_next = last
    rows = torch.arange(B, device=lp.device)
    for j in range(T_feats - 2, -1, -1):
        i_b = a_next
        i_a = torch.clamp(a_next - 1, min=0)
        q_a = q[rows, j, i_a]
        q_b = q[rows, j, i_b]
        choice = torch.where(i_b == 0, 0, torch.where(q_a >= q_b, i_a, i_b))
        a_next = torch.where(j >= feats_lengths - 1, last, choice)
        path[:, j] = a_next
    return path


def viterbi_decode(log_p_attn, text_lengths, feats_lengths):
    """Durations (B, T_text) float32 and the binarisation loss (scalar)."""
    B, T_feats, T_text = log_p_attn.shape
    paths = monotonic_alignment_search(log_p_attn, text_lengths, feats_lengths)
    frame_valid = (
        torch.arange(T_feats, device=log_p_attn.device)[None, :] < feats_lengths[:, None]
    )
    onehot = torch.nn.functional.one_hot(paths, T_text).float()
    ds = (onehot * frame_valid[..., None]).sum(dim=1)
    picked = torch.gather(log_p_attn, 2, paths[..., None])[..., 0]
    per_item = -(picked * frame_valid).sum(dim=1) / torch.clamp(feats_lengths, min=1)
    return ds, per_item.mean()
