"""Multi-head attention: standard (``MultiHeadedAttention``, mirrors
seq2seq_vc_tpu/nn/attention.py:76-170) and with relative positions, new
style (``RelPositionMultiHeadedAttention``, :173-400) and legacy
(``LegacyRelPositionMultiHeadedAttention``, :403-406).

``MultiHeadedAttention`` has two backends: ``xla`` (dense PyTorch ops) and
``flash`` (the standard flash kernels, forward and backward, at key lengths
>= ``flash_min_len`` under a key-padding mask; dense below it or with any
other mask). The relative-position module's backends keep the JAX
package's names: ``xla`` (dense PyTorch ops),
``fused`` (the fused rel-scores kernel, dense softmax and AV; its backward
is the variant ``rel_scores_bwd`` names) and ``flash`` (the rel-pos flash
kernels at key lengths >= ``flash_min_len``, forward and backward, the
fused path below it; the legacy module never takes the fused kernel, so
below the gate it takes the dense ops, as in the JAX package). Attention
dropout acts on the softmax weights in
``train()`` mode: on the flash path inside the kernels, from one seed per
call drawn from torch's default CPU generator (which the trainer seeds), as
the JAX package draws one from its dropout rng.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.attention import scaled_dot_attention
from ..ops.flash_attention import flash_attention, rel_flash_attention
from ..ops.rel_scores import fused_rel_scores
from .layers import Linear

# Key length from which the `flash` backend takes the flash kernels, in
# training and inference, in both modules. PROVISIONAL: it is not the
# TPU's FLASH_MIN_LEN (3072), which was tuned to TPU limits. `python3
# chip_smoke.py --flash-sweep` times one layer's forward + backward through
# both routes of each module on an H100 (PERF.md); the gate stays here
# until the CUDA-core kernels are redesigned, and is re-set from that sweep
# then. Below it the rel-pos module's `flash` backend takes the
# fused-scores kernel and the standard module's the dense ops.
FLASH_MIN_LEN = 2048
# dropout seeds are drawn in [0, SEED_HIGH), as the JAX package draws them
SEED_HIGH = 2**31 - 1


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _expand_mask(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Broadcast a (B, Tk) / (B, Tq, Tk) / (B, 1, Tk) mask to (B, 1, Tq, Tk)."""
    if mask is None:
        return None
    if mask.dim() == 2:
        mask = mask[:, None, :]
    return mask[:, None, :, :]


def _is_key_padding(mask) -> bool:
    return mask is None or mask.dim() == 2 or (mask.dim() == 3 and mask.shape[1] == 1)


def _kv_lens(mask) -> Optional[torch.Tensor]:
    """(B,) key lengths of a prefix-true key-padding mask (None: all keys)."""
    if mask is None:
        return None
    return (mask if mask.dim() == 2 else mask[:, 0, :]).sum(-1).to(torch.int32)


def _flash_seed(rate: float) -> Optional[int]:
    return int(torch.randint(0, SEED_HIGH, ())) if rate > 0.0 else None


class MultiHeadedAttention(torch.nn.Module):
    """Standard scaled dot-product MHA with q/k/v/out projections.

    Scores and softmax run in float32; projections and the weights-times-V
    product in ``compute_dtype``. The ``flash`` backend takes the flash
    kernels when no weights are asked for, the key length reaches
    ``flash_min_len`` and the mask (if any) is a key-padding mask; in
    ``train()`` mode its dropout seed is drawn from torch's default CPU
    generator, one per call.
    """

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0,
                 backend: str = "xla", compute_dtype=None,
                 flash_min_len: int = FLASH_MIN_LEN, device=None, dtype=None):
        super().__init__()
        if backend not in ("xla", "flash"):
            raise ValueError(f"unknown attention backend: {backend}")
        self.n_head = n_head
        self.d_k = n_feat // n_head
        self.dropout_rate = dropout_rate
        self.backend = backend
        self.flash_min_len = flash_min_len
        kw = dict(compute_dtype=compute_dtype, device=device, dtype=dtype)
        self.linear_q = Linear(n_feat, n_feat, **kw)
        self.linear_k = Linear(n_feat, n_feat, **kw)
        self.linear_v = Linear(n_feat, n_feat, **kw)
        self.linear_out = Linear(n_feat, n_feat, **kw)

    def route(self, t_key: int, mask, return_weights: bool = False) -> str:
        """Which path a call takes: 'flash' or 'xla'."""
        if (self.backend == "flash" and not return_weights and t_key >= self.flash_min_len
                and _is_key_padding(mask)):
            return "flash"
        return "xla"

    def forward(self, query, key, value, mask=None, return_weights: bool = False):
        """mask: (B, Tk), (B, 1, Tk) or (B, Tq, Tk), True where attention is
        allowed. Returns the (B, Tq, n_feat) output and, with
        ``return_weights``, the float32 (B, H, Tq, Tk) weights (after
        dropout in ``train()`` mode, as the JAX module returns them)."""
        q = _split_heads(self.linear_q(query), self.n_head)
        k = _split_heads(self.linear_k(key), self.n_head)
        v = _split_heads(self.linear_v(value), self.n_head)
        if self.route(key.shape[1], mask, return_weights) == "flash":
            rate = float(self.dropout_rate) if self.training else 0.0
            out = flash_attention(q, k, v, kv_lens=_kv_lens(mask), dropout_rate=rate,
                                  dropout_seed=_flash_seed(rate))
            return self.linear_out(_merge_heads(out))
        out, w = scaled_dot_attention(q, k, v, mask=_expand_mask(mask), return_weights=True)
        if self.training and self.dropout_rate > 0.0:
            # torch's default generator draws the mask (the trainer seeds it)
            w = F.dropout(w, self.dropout_rate, True)
            out = torch.matmul(w.to(v.dtype), v)
        out = self.linear_out(_merge_heads(out))
        return (out, w) if return_weights else out

    def project_kv(self, key, value):
        """Head-split K/V projections, for decode caches: (B, H, T, d_k)."""
        return (_split_heads(self.linear_k(key), self.n_head),
                _split_heads(self.linear_v(value), self.n_head))

    def attend_with_kv(self, query, k, v, mask=None, return_weights: bool = False):
        """Attention over cached K/V (the incremental decode path)."""
        q = _split_heads(self.linear_q(query), self.n_head)
        out = scaled_dot_attention(q, k, v, mask=mask, return_weights=return_weights)
        if return_weights:
            return self.linear_out(_merge_heads(out[0])), out[1]
        return self.linear_out(_merge_heads(out))


def rel_shift(x: torch.Tensor, legacy: bool = False) -> torch.Tensor:
    """Transformer-XL shift. New style: (B, H, T, 2T-1) scores against
    +-(T-1) positions -> (B, H, T, T). Legacy: (B, H, T, T) -> (B, H, T, T)
    by the same view moves, whose wrap gives ``bd[i, j] = x[i, T-1-(i-j)]``
    for j <= i, 0 for j = i + 1 and ``x[i+1, j-i-2]`` for j >= i + 2."""
    b, h, t, n = x.shape
    x = torch.nn.functional.pad(x, (1, 0))
    x = x.reshape(b, h, n + 1, t)[:, :, 1:, :].reshape(b, h, t, n)
    return x if legacy else x[:, :, :, : (n + 1) // 2]


class RelPositionMultiHeadedAttention(torch.nn.Module):
    """MHA with Transformer-XL relative position encoding (new style).

    Expects pos_emb of shape (1, 2T-1, n_feat) from RelPositionalEncoding.
    Scores and softmax run in float32; projections in ``compute_dtype``.
    """

    legacy = False  # the legacy form: LegacyRelPositionMultiHeadedAttention

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0,
                 zero_triu: bool = False, backend: str = "xla", compute_dtype=None,
                 flash_min_len: int = FLASH_MIN_LEN, rel_scores_bwd: str = "auto",
                 device=None, dtype=None):
        super().__init__()
        if backend not in ("xla", "fused", "flash"):
            raise ValueError(f"unknown attention backend: {backend}")
        self.n_head = n_head
        self.d_k = n_feat // n_head
        self.dropout_rate = dropout_rate
        self.zero_triu = zero_triu
        self.backend = backend
        self.flash_min_len = flash_min_len
        self.rel_scores_bwd = rel_scores_bwd
        kw = dict(compute_dtype=compute_dtype, device=device, dtype=dtype)
        self.linear_q = Linear(n_feat, n_feat, **kw)
        self.linear_k = Linear(n_feat, n_feat, **kw)
        self.linear_v = Linear(n_feat, n_feat, **kw)
        self.linear_out = Linear(n_feat, n_feat, **kw)
        self.linear_pos = Linear(n_feat, n_feat, bias=False, **kw)
        self.pos_bias_u = torch.nn.Parameter(torch.empty(n_head, self.d_k, device=device, dtype=dtype))
        self.pos_bias_v = torch.nn.Parameter(torch.empty(n_head, self.d_k, device=device, dtype=dtype))
        torch.nn.init.xavier_uniform_(self.pos_bias_u)
        torch.nn.init.xavier_uniform_(self.pos_bias_v)

    def route(self, t_query: int, t_key: int, n_pos: int, mask) -> str:
        """Which path a call takes: 'flash', 'fused' or 'xla'."""
        if (
            self.backend == "flash" and not self.zero_triu
            and t_key >= self.flash_min_len and _is_key_padding(mask)
        ):
            return "flash"
        if (
            self.backend in ("fused", "flash") and not self.legacy and not self.zero_triu
            and t_key == t_query and n_pos == 2 * t_query - 1
        ):
            return "fused"
        return "xla"

    def forward(self, query, key, value, pos_emb, mask=None):
        q = _split_heads(self.linear_q(query), self.n_head)
        k = _split_heads(self.linear_k(key), self.n_head)
        v = _split_heads(self.linear_v(value), self.n_head)
        p = _split_heads(self.linear_pos(pos_emb.to(q.dtype)), self.n_head)
        q_u = q + self.pos_bias_u[None, :, None, :].to(q.dtype)
        q_v = q + self.pos_bias_v[None, :, None, :].to(q.dtype)

        path = self.route(query.shape[1], key.shape[1], pos_emb.shape[1], mask)
        if path == "flash":
            rate = float(self.dropout_rate) if self.training else 0.0
            out = rel_flash_attention(q_u, q_v, k, v, p[0], kv_lens=_kv_lens(mask),
                                      dropout_rate=rate, dropout_seed=_flash_seed(rate),
                                      legacy=self.legacy)
            return self.linear_out(_merge_heads(out))
        if path == "fused":
            scores = fused_rel_scores(q_u, q_v, k, p[0], bwd=self.rel_scores_bwd)
        else:
            matrix_ac = torch.einsum("bhqd,bhkd->bhqk", q_u.float(), k.float())
            matrix_bd = rel_shift(torch.einsum("bhqd,bhpd->bhqp", q_v.float(), p.float()),
                                  self.legacy)
            if self.zero_triu:
                matrix_bd = torch.tril(matrix_bd)
            scores = (matrix_ac + matrix_bd) / math.sqrt(self.d_k)
        m = _expand_mask(mask)
        if m is not None:
            scores = scores.masked_fill(~m, -1e9)
        w = torch.softmax(scores, dim=-1)
        if m is not None:
            w = w.masked_fill(~m, 0.0)
        # torch's default generator draws the mask (the trainer seeds it):
        # PyTorch's dropout takes no generator argument
        w = F.dropout(w, self.dropout_rate, self.training)
        out = torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype).float(), v.float()).to(v.dtype)
        return self.linear_out(_merge_heads(out))


class LegacyRelPositionMultiHeadedAttention(RelPositionMultiHeadedAttention):
    """Legacy variant: pos_emb of shape (1, T, n_feat) from
    LegacyRelPositionalEncoding, the legacy ``rel_shift``; on the flash
    route the same kernels in their legacy form, D wide (q_v and the (H, T,
    D) table as the module holds them; each band cell reads q_v row i or
    i + 1 by the sign of j - i)."""

    legacy = True
