"""Conformer encoder (mirrors seq2seq_vc_tpu/nn/conformer.py).

Macaron FFN x0.5, rel-pos self-attention (new style, or legacy with the
``legacy_rel_selfattn`` layer type and the ``legacy_rel_pos`` encoding),
GLU conv module, final LN. In
``train()`` mode dropout acts where the JAX modules apply it: after the
input layer, on the positional encoding, inside the feed-forwards, on the
attention weights, and on each residual branch. The
conv module's norm is ``MaskedGroupNorm`` (the JAX package's default):
single-group statistics over valid frames only, so outputs do not depend on
the pad length; or, with ``conv_norm_type="batch_norm"``, ``ConvBatchNorm``
(flax ``nn.BatchNorm``'s semantics, the espnet conformer's module).
Submodule names follow the reference torch code
(``encoders.N.self_attn.linear_pos``, ``conv_module.norm`` ...), which
``seq2seq_vc_tpu/convert/reference.py`` consumes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .attention import (
    FLASH_MIN_LEN,
    LegacyRelPositionMultiHeadedAttention,
    RelPositionMultiHeadedAttention,
)
from .layers import Conv1d, LayerNorm, Linear
from .transformer import LN_EPS, Conv2dSubsampling, _make_pos_enc, _positionwise


class MaskedGroupNorm(torch.nn.Module):
    """Single-group norm whose statistics ignore padded positions.

    x: (B, T, C); mask: (B, T) True at valid frames, or None. Statistics in
    float32; the output keeps the input dtype.
    """

    def __init__(self, channels: int, eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(channels, device=device, dtype=dtype))
        self.bias = torch.nn.Parameter(torch.zeros(channels, device=device, dtype=dtype))

    def forward(self, x, mask=None):
        c = x.shape[-1]
        xf = x.float()
        if mask is None:
            mean = xf.mean(dim=(1, 2), keepdim=True)
            var = ((xf - mean) ** 2).mean(dim=(1, 2), keepdim=True)
        else:
            m = mask[..., None].float()
            denom = torch.clamp(m.sum(dim=(1, 2), keepdim=True) * c, min=1.0)
            mean = (xf * m).sum(dim=(1, 2), keepdim=True) / denom
            var = (((xf - mean) * m) ** 2).sum(dim=(1, 2), keepdim=True) / denom
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


class ConvBatchNorm(torch.nn.BatchNorm1d):
    """Batch norm over (B, T, C) with flax ``nn.BatchNorm``'s semantics
    (seq2seq_vc_tpu/nn/conformer.py:92-97): in ``train()`` mode it
    normalises with the batch's mean and biased variance over every frame,
    padded ones included (flax's one-pass E[x^2] - E[x]^2 in float32,
    floored at 0), and moves the running statistics by 0.01 of the batch's
    (flax momentum 0.99) with that variance, where torch's ``BatchNorm1d``
    would take the unbiased one; in ``eval()`` mode it
    uses the running statistics. eps 1e-5. The output is float32, as flax
    promotes it. Holds torch's names (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``)."""

    def __init__(self, channels: int, device=None, dtype=None):
        super().__init__(channels, eps=1e-5, momentum=0.01, device=device, dtype=dtype)

    def forward(self, x, mask=None):
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 1))
            var = torch.clamp((xf * xf).mean(dim=(0, 1)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
                self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight.float() + self.bias.float()


class ConvolutionModule(torch.nn.Module):
    """Pointwise(2C) -> GLU -> depthwise -> norm -> swish -> pointwise."""

    def __init__(self, channels: int, kernel_size: int, compute_dtype=None,
                 conv_norm_type: str = "group_norm", device=None, dtype=None):
        super().__init__()
        if (kernel_size - 1) % 2:
            raise ValueError("conv module kernel size must be odd")
        kw = dict(compute_dtype=compute_dtype, device=device, dtype=dtype)
        self.pointwise_conv1 = Conv1d(channels, 2 * channels, 1, **kw)
        self.depthwise_conv = Conv1d(channels, channels, kernel_size, groups=channels, **kw)
        norms = {"group_norm": MaskedGroupNorm, "batch_norm": ConvBatchNorm}
        if conv_norm_type not in norms:
            raise ValueError(f"conv_norm_type {conv_norm_type!r}")
        self.norm = norms[conv_norm_type](channels, device=device, dtype=dtype)
        self.pointwise_conv2 = Conv1d(channels, channels, 1, **kw)

    def forward(self, x, mask=None):
        if mask is not None:
            x = x * mask[..., None].to(x.dtype)
        h = F.glu(self.pointwise_conv1(x), dim=-1)
        if mask is not None:
            h = h * mask[..., None].to(h.dtype)
        h = self.norm(self.depthwise_conv(h), mask)
        return self.pointwise_conv2(F.silu(h))


class ConformerEncoderLayer(torch.nn.Module):
    """Macaron-FFN + rel-pos MHA + conv module + FFN + final LN."""

    def __init__(self, size: int, n_head: int, linear_units: int,
                 dropout_rate: float = 0.1, attention_dropout_rate: float = 0.0,
                 normalize_before: bool = True, concat_after: bool = False,
                 positionwise_layer_type: str = "linear", macaron_style: bool = True,
                 use_cnn_module: bool = True, cnn_module_kernel: int = 31,
                 zero_triu: bool = False, attention_backend: str = "xla",
                 flash_min_len: int = FLASH_MIN_LEN, rel_scores_bwd: str = "auto",
                 legacy: bool = False, compute_dtype=None, conv_norm_type: str = "group_norm",
                 positionwise_conv_kernel_size: int = 1, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ln = dict(compute_dtype=compute_dtype, **kw)
        self.dropout_rate = dropout_rate
        self.normalize_before = normalize_before
        self.concat_after = concat_after
        self.macaron_style = macaron_style
        self.use_cnn_module = use_cnn_module
        attention = (LegacyRelPositionMultiHeadedAttention if legacy
                     else RelPositionMultiHeadedAttention)
        self.self_attn = attention(
            n_head, size, attention_dropout_rate, zero_triu=zero_triu,
            backend=attention_backend, compute_dtype=compute_dtype,
            flash_min_len=flash_min_len, rel_scores_bwd=rel_scores_bwd, **kw,
        )
        # the conformer passes Swish into the linear-flavour FFN; the conv
        # flavours keep their ReLU
        ff = (positionwise_layer_type, size, linear_units, dropout_rate, compute_dtype, "swish",
              positionwise_conv_kernel_size)
        self.feed_forward = _positionwise(*ff, **kw)
        if macaron_style:
            self.feed_forward_macaron = _positionwise(*ff, **kw)
            self.norm_ff_macaron = LayerNorm(size, LN_EPS, **ln)
        if use_cnn_module:
            self.conv_module = ConvolutionModule(size, cnn_module_kernel, compute_dtype,
                                                 conv_norm_type, **kw)
            self.norm_conv = LayerNorm(size, LN_EPS, **ln)
            self.norm_final = LayerNorm(size, LN_EPS, **ln)
        self.norm_ff = LayerNorm(size, LN_EPS, **ln)
        self.norm_mha = LayerNorm(size, LN_EPS, **ln)
        if concat_after:
            self.concat_linear = Linear(2 * size, size, **ln)

    def _drop(self, x):
        return F.dropout(x, self.dropout_rate, self.training)

    def forward(self, x, mask, pos_emb):
        ff_scale = 0.5 if self.macaron_style else 1.0
        if self.macaron_style:
            residual = x
            h = self.norm_ff_macaron(x) if self.normalize_before else x
            x = residual + ff_scale * self._drop(self.feed_forward_macaron(h))
            if not self.normalize_before:
                x = self.norm_ff_macaron(x)

        residual = x
        h = self.norm_mha(x) if self.normalize_before else x
        att = self.self_attn(h, h, h, pos_emb, mask)
        if self.concat_after:
            x = residual + self.concat_linear(torch.cat([h, att], dim=-1))
        else:
            x = residual + self._drop(att)
        if not self.normalize_before:
            x = self.norm_mha(x)

        if self.use_cnn_module:
            residual = x
            h = self.norm_conv(x) if self.normalize_before else x
            frame_mask = None if mask is None else mask[:, 0, :]
            x = residual + self._drop(self.conv_module(h, frame_mask))
            if not self.normalize_before:
                x = self.norm_conv(x)

        residual = x
        h = self.norm_ff(x) if self.normalize_before else x
        x = residual + ff_scale * self._drop(self.feed_forward(h))
        if not self.normalize_before:
            x = self.norm_ff(x)

        if self.use_cnn_module:
            x = self.norm_final(x)
        return x


class ConformerEncoder(torch.nn.Module):
    """Conformer encoder with a ``linear``, a ``conv2d`` (x4 subsampling) or
    no (``None``) input layer."""

    def __init__(self, idim: int, attention_dim: int = 256, attention_heads: int = 4,
                 linear_units: int = 2048, num_blocks: int = 6,
                 dropout_rate: float = 0.1, positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 input_layer: Optional[str] = "linear", normalize_before: bool = True,
                 concat_after: bool = False, positionwise_layer_type: str = "linear",
                 positionwise_conv_kernel_size: int = 1,
                 macaron_style: bool = True, pos_enc_layer_type: str = "rel_pos",
                 selfattention_layer_type: str = "rel_selfattn",
                 use_cnn_module: bool = True, cnn_module_kernel: int = 31,
                 conv_norm_type: str = "group_norm", zero_triu: bool = False,
                 attention_backend: str = "xla", flash_min_len: int = FLASH_MIN_LEN,
                 rel_scores_bwd: str = "auto", compute_dtype=None, device=None,
                 dtype=None):
        super().__init__()
        if selfattention_layer_type not in ("rel_selfattn", "legacy_rel_selfattn"):
            raise NotImplementedError(
                f"selfattention_layer_type {selfattention_layer_type!r} is not ported yet"
            )
        kw = dict(device=device, dtype=dtype)
        self.input_layer = input_layer
        self.compute_dtype = compute_dtype
        self.dropout_rate = dropout_rate
        if input_layer == "linear":
            # Linear -> LN(eps 1e-5); no ReLU (conformer/encoder.py:117-122)
            self.embed = torch.nn.Sequential(
                Linear(idim, attention_dim, **kw), LayerNorm(attention_dim, 1e-5, **kw)
            )
        elif input_layer == "conv2d":
            # the reference names (embed.conv.0, embed.conv.2, embed.out.0);
            # the relative encoding returns (xs, pos_emb), so it runs after
            # the subsampling as self.pos_enc, not inside ``out``
            self.embed = Conv2dSubsampling(idim, attention_dim, torch.nn.Identity(), **kw)
        elif input_layer is not None:
            raise NotImplementedError(f"input_layer {input_layer!r} is not ported yet")
        self.pos_enc = _make_pos_enc(pos_enc_layer_type, attention_dim, positional_dropout_rate)
        self.encoders = torch.nn.ModuleList(
            ConformerEncoderLayer(
                attention_dim, attention_heads, linear_units, dropout_rate,
                attention_dropout_rate, normalize_before, concat_after,
                positionwise_layer_type, macaron_style, use_cnn_module,
                cnn_module_kernel, zero_triu, attention_backend, flash_min_len,
                rel_scores_bwd, selfattention_layer_type == "legacy_rel_selfattn",
                compute_dtype, conv_norm_type, positionwise_conv_kernel_size, **kw,
            )
            for _ in range(num_blocks)
        )
        self.normalize_before = normalize_before
        if normalize_before:
            self.after_norm = LayerNorm(attention_dim, LN_EPS, compute_dtype, **kw)

    def forward(self, xs, masks: Optional[torch.Tensor]):
        """xs: (B, T, idim); masks: (B, T) non-pad. Returns (float32 xs, masks),
        both subsampled by a ``conv2d`` input layer."""
        if self.input_layer == "linear":
            xs = F.dropout(self.embed(xs), self.dropout_rate, self.training)
        elif self.input_layer == "conv2d":
            xs, masks = self.embed(xs, masks)
        xs, pos_emb = self.pos_enc(xs)
        if self.compute_dtype is not None:
            xs = xs.to(self.compute_dtype)
        attn_mask = None if masks is None else masks[:, None, :]
        for layer in self.encoders:
            xs = layer(xs, attn_mask, pos_emb)
        if self.normalize_before:
            xs = self.after_norm(xs)
        return xs.float(), masks
