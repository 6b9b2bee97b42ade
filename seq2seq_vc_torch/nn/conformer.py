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

Model parallelism (set by ``parallel/plan.py``; mirrors
seq2seq_vc_tpu/nn/conformer.py:259-263,355-433):

- sequence parallelism (``sp``, the seq group): the encoder pads the time
  axis to a multiple of the ranks (masked frames: every layer ignores
  them), each rank's layers take its block of frames, and the blocks are
  gathered after the last layer. The attention takes the ring route
  against the whole sequence's mask and positional table; the conv
  module's depthwise conv takes its ``(kernel - 1) / 2`` halo frames from
  each neighbour (none at the sequence's ends, as SAME padding's zeros);
  the norm's statistics, sums over the whole time axis, are summed over
  the group (what GSPMD does for the JAX package without being asked);
- pipeline parallelism (``pipe``, the pipe group): the encoder GPipes its
  layer stack (``parallel/pp.py``) in ``n_micro`` microbatches, a stage
  holding its block of layers (the others are ``Identity`` placeholders,
  so a layer keeps its name). The two exclude each other.

Inside either, dropout draws the rank's own masks (``mesh.group_rng``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel import collectives
from ..parallel.mesh import group_rng
from ..parallel.pp import pipeline_module_stack
from .attention import FLASH_MIN_LEN
from .layers import Conv1d, LayerNorm, Linear
from .transformer import (
    LN_EPS,
    Conv2dSubsampling,
    _make_pos_enc,
    _positionwise,
    self_attention,
)

# the conformer's ``pos_enc_layer_type`` -> the encoding's kind
_POS_ENC_KINDS = {"abs_pos": "abs", "scaled_abs_pos": "scaled", "rel_pos": "rel_pos",
                  "legacy_rel_pos": "legacy_rel_pos"}


class MaskedGroupNorm(torch.nn.Module):
    """Single-group norm whose statistics ignore padded positions.

    x: (B, T, C); mask: (B, T) True at valid frames, or None. Statistics in
    float32; the output keeps the input dtype. Under sequence parallelism
    (``sp``) x is a rank's block of frames and the sums run over the group.
    """

    sp = None

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

            def total(t):
                return collectives.sum_over(t.sum(dim=(1, 2), keepdim=True), self.sp)

            denom = torch.clamp(total(m) * c, min=1.0)
            mean = total(xf * m) / denom
            var = total(((xf - mean) * m) ** 2) / denom
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
    """Pointwise(2C) -> GLU -> depthwise -> norm -> swish -> pointwise.
    Under sequence parallelism (``sp``) the depthwise conv reads its halo
    from the neighbouring ranks."""

    sp = None

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
        h = self.norm(self._depthwise(h), mask)
        return self.pointwise_conv2(F.silu(h))

    def _depthwise(self, h):
        pad = (self.depthwise_conv.kernel_size[0] - 1) // 2
        if self.sp is None or pad == 0:
            return self.depthwise_conv(h)
        if pad > h.shape[1]:
            raise ValueError(f"sequence parallelism: a rank's {h.shape[1]} frames are fewer "
                             f"than the depthwise conv's halo of {pad}")
        n, r = collectives.size(self.sp), collectives.rank(self.sp)
        (prev,) = collectives.shift([h[:, -pad:]], self.sp, 1)  # the tail of the rank before
        (nxt,) = collectives.shift([h[:, :pad]], self.sp, -1)  # the head of the rank after
        # the sequence's ends read zeros (SAME padding); the factor keeps
        # every rank's shifts in its graph
        h = torch.cat([prev * float(r > 0), h, nxt * float(r < n - 1)], dim=1)
        return self.depthwise_conv(h, padding=0)


class ConformerEncoderLayer(torch.nn.Module):
    """Macaron-FFN + MHA + conv module + FFN + final LN. The MHA is
    ``selfattention_layer_type``'s: rel-pos (new style or legacy), or the
    standard one (``selfattn``), which takes no ``pos_emb``. Under
    sequence parallelism (``sp``) x is a rank's block of frames and
    ``mask`` the whole sequence's."""

    sp = None

    def __init__(self, size: int, n_head: int, linear_units: int,
                 dropout_rate: float = 0.1, attention_dropout_rate: float = 0.0,
                 normalize_before: bool = True, concat_after: bool = False,
                 positionwise_layer_type: str = "linear", macaron_style: bool = True,
                 use_cnn_module: bool = True, cnn_module_kernel: int = 31,
                 zero_triu: bool = False, attention_backend: str = "xla",
                 flash_min_len: int = FLASH_MIN_LEN, rel_scores_bwd: str = "auto",
                 selfattention_layer_type: str = "rel_selfattn", compute_dtype=None,
                 conv_norm_type: str = "group_norm", positionwise_conv_kernel_size: int = 1,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ln = dict(compute_dtype=compute_dtype, **kw)
        self.dropout_rate = dropout_rate
        self.normalize_before = normalize_before
        self.concat_after = concat_after
        self.macaron_style = macaron_style
        self.use_cnn_module = use_cnn_module
        self.self_attn = self_attention(selfattention_layer_type, n_head, size,
                                        attention_dropout_rate, attention_backend,
                                        flash_min_len, compute_dtype, zero_triu,
                                        rel_scores_bwd, **kw)
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
        if pos_emb is not None:
            att = self.self_attn(h, h, h, pos_emb, mask)
        else:
            att = self.self_attn(h, h, h, mask)
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
            if self.sp is not None:
                frame_mask = collectives.block(frame_mask, self.sp, 1)
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
    """Conformer encoder with a ``linear``, a ``conv2d`` (x4 subsampling), an
    ``embed`` (a token embedding of ``idim`` rows) or no (``None``) input
    layer, and the ``pos_enc_layer_type`` encoding: relative (``rel_pos``,
    ``legacy_rel_pos``) or absolute (``abs_pos``: x * sqrt(d) + PE;
    ``scaled_abs_pos``: x + alpha * PE), the absolute ones with no table for
    the layers. ``sp`` and ``pipe`` (with ``n_micro``) are the model
    parallelism of the module's docstring."""

    sp = pipe = None
    n_micro = 1

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
        elif input_layer == "embed":
            self.embed = torch.nn.Embedding(idim, attention_dim, **kw)
            torch.nn.init.normal_(self.embed.weight, std=attention_dim ** -0.5)
        elif input_layer is not None:
            raise ValueError(f"unknown input_layer: {input_layer}")
        self.pos_enc = _make_pos_enc(_POS_ENC_KINDS[pos_enc_layer_type], attention_dim,
                                     positional_dropout_rate, device=device)
        self.encoders = torch.nn.ModuleList(
            ConformerEncoderLayer(
                attention_dim, attention_heads, linear_units, dropout_rate,
                attention_dropout_rate, normalize_before, concat_after,
                positionwise_layer_type, macaron_style, use_cnn_module,
                cnn_module_kernel, zero_triu, attention_backend, flash_min_len,
                rel_scores_bwd, selfattention_layer_type, compute_dtype, conv_norm_type,
                positionwise_conv_kernel_size, **kw,
            )
            for _ in range(num_blocks)
        )
        self.normalize_before = normalize_before
        if normalize_before:
            self.after_norm = LayerNorm(attention_dim, LN_EPS, compute_dtype, **kw)

    @property
    def conv_subsampling_factor(self) -> int:
        return 4 if self.input_layer == "conv2d" else 1

    def forward(self, xs, masks: Optional[torch.Tensor]):
        """xs: (B, T, idim), or (B, T) integer tokens for ``embed``; masks:
        (B, T) non-pad. Returns (float32 xs, masks), both subsampled by a
        ``conv2d`` input layer."""
        if self.input_layer == "linear":
            xs = F.dropout(self.embed(xs), self.dropout_rate, self.training)
        elif self.input_layer == "conv2d":
            xs, masks = self.embed(xs, masks)
        elif self.input_layer == "embed":
            xs = self.embed(xs)
        xs = self.pos_enc(xs)
        xs, pos_emb = xs if isinstance(xs, tuple) else (xs, None)
        if self.compute_dtype is not None:
            xs = xs.to(self.compute_dtype)
        if self.pipe is not None:
            xs = self._pipelined(xs, masks, pos_emb)
        elif self.sp is not None:
            xs = self._sequence_parallel(xs, masks, pos_emb)
        else:
            attn_mask = None if masks is None else masks[:, None, :]
            for layer in self.encoders:
                xs = layer(xs, attn_mask, pos_emb)
        if self.normalize_before:
            xs = self.after_norm(xs)
        return xs.float(), masks

    def _sequence_parallel(self, xs, masks, pos_emb):
        """The layers on this rank's block of frames; the whole sequence
        back."""
        g = self.sp
        B, T = xs.shape[:2]
        pad = -T % collectives.size(g)
        masks = torch.ones(B, T, dtype=torch.bool, device=xs.device) if masks is None else masks
        if pad:
            xs, masks = F.pad(xs, (0, 0, 0, pad)), F.pad(masks, (0, pad), value=False)
        h = collectives.split(xs, g, 1)
        pe = None if pos_emb is None else collectives.copy_to(pos_emb, g)
        with group_rng(g, xs.device, self.training):
            for layer in self.encoders:
                h = layer(h, masks[:, None, :], pe)
        return collectives.gather(h, g, 1)[:, :T]

    def _pipelined(self, xs, masks, pos_emb):
        """The layer stack GPipe-pipelined over the pipe group: this stage's
        layers on each microbatch it holds."""
        layers = [m for m in self.encoders if not isinstance(m, torch.nn.Identity)]
        pe = None if pos_emb is None else collectives.copy_to(pos_emb, self.pipe)

        def stage(h, mask):
            for layer in layers:
                h = layer(h, None if mask is None else mask[:, None, :], pe)
            return h

        with group_rng(self.pipe, xs.device, self.training):
            return pipeline_module_stack(stage, xs, masks, self.pipe, self.n_micro)
