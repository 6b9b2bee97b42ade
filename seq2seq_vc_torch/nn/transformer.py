"""Transformer stack (mirrors seq2seq_vc_tpu/nn/transformer.py): LN_EPS,
the position-wise feed-forward and its conv forms (``MultiLayeredConv1d``,
``Conv1dLinear``), the positional-encoding factory,
Conv2dSubsampling, and the VTN's encoder and decoder (``EncoderLayer``,
``Encoder``, ``DecoderLayer``, ``Decoder``).

Pre- or post-LN residual blocks with LayerNorm eps 1e-12 and the
``concat_after`` option. Autoregressive decoding keeps a per-layer K/V
cache of fixed size, written in place one step at a time; a step attends
over the cache's first t + 1 entries (the JAX package attends over the
whole buffer with the later entries masked, whose weights are exactly 0).
Cross-attention K/V are projected once per utterance
(``precompute_memory``). Submodule names follow the reference torch code
(``encoders.N.self_attn.linear_q``, ``decoders.N.src_attn``,
``embed.out.1.alpha`` ...), which ``seq2seq_vc_tpu/convert/reference.py``
consumes. Under tensor parallelism (``parallel/tp.py``) a feed-forward's
``w_1`` is split by column and its ``w_2`` by row over the model group
``tp``; the decode caches hold a rank's heads.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .attention import (
    FLASH_MIN_LEN,
    LegacyRelPositionMultiHeadedAttention,
    MultiHeadedAttention,
    RelPositionMultiHeadedAttention,
)
from ..parallel import tp as tensor_parallel
from ..parallel.mesh import group_rng
from .layers import Conv1d, LayerNorm, Linear
from .positional_encoding import (
    LegacyRelPositionalEncoding,
    PositionalEncoding,
    RelPositionalEncoding,
    ScaledPositionalEncoding,
)

LN_EPS = 1e-12  # the reference layer_norm.py uses eps=1e-12


class _SplitFeedForward(torch.nn.Module):
    """w_2(dropout(act(w_1(x)))), with ``w_1`` split by column and ``w_2``
    by row over the model group ``tp`` when ``parallel/tp.py`` splits it
    (the hidden dropout then draws the rank's own mask)."""

    tp = None

    def _act(self, h):
        raise NotImplementedError

    def forward(self, x):
        x = tensor_parallel.enter(x, self.tp)
        with group_rng(self.tp, x.device, self.training and self.dropout_rate > 0.0):
            h = F.dropout(self._act(self.w_1(x)), self.dropout_rate, self.training)
        return tensor_parallel.row_out(self.w_2, h, self.tp)


class PositionwiseFeedForward(_SplitFeedForward):
    """w_2(dropout(act(w_1(x)))); the dropout acts in ``train()`` mode."""

    def __init__(self, idim: int, hidden_units: int, dropout_rate: float = 0.1,
                 activation: str = "relu", compute_dtype=None, device=None, dtype=None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, device=device, dtype=dtype)
        self.w_1 = Linear(idim, hidden_units, **kw)
        self.w_2 = Linear(hidden_units, idim, **kw)
        self.act = F.silu if activation == "swish" else F.relu
        self.dropout_rate = dropout_rate

    def _act(self, h):
        return self.act(h)


class MultiLayeredConv1d(_SplitFeedForward):
    """w_2(dropout(relu(w_1(x)))) with both layers ``Conv1d`` of
    ``kernel_size`` taps over time, flax's SAME padding (FastSpeech's
    positionwise layer; the ReLU whatever the caller's activation)."""

    def __init__(self, idim: int, hidden_chans: int, kernel_size: int,
                 dropout_rate: float = 0.1, compute_dtype=None, device=None, dtype=None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, device=device, dtype=dtype)
        self.w_1 = Conv1d(idim, hidden_chans, kernel_size, **kw)
        self.w_2 = Conv1d(hidden_chans, idim, kernel_size, **kw)
        self.dropout_rate = dropout_rate

    def _act(self, h):
        return F.relu(h)


class Conv1dLinear(MultiLayeredConv1d):
    """As ``MultiLayeredConv1d`` with ``w_2`` a ``Linear``."""

    def __init__(self, idim: int, hidden_chans: int, kernel_size: int,
                 dropout_rate: float = 0.1, compute_dtype=None, device=None, dtype=None):
        super().__init__(idim, hidden_chans, kernel_size, dropout_rate, compute_dtype,
                         device, dtype)
        self.w_2 = Linear(hidden_chans, idim, compute_dtype=compute_dtype, device=device,
                          dtype=dtype)


def _positionwise(kind: str, idim: int, linear_units: int, dropout_rate: float = 0.1,
                  compute_dtype=None, activation: str = "relu", kernel_size: int = 1,
                  device=None, dtype=None):
    """The positionwise layer of ``positionwise_layer_type`` ``kind``;
    ``activation`` acts only in the ``linear`` kind, ``kernel_size`` only
    in the conv kinds (the JAX package's ``_positionwise``)."""
    kw = dict(device=device, dtype=dtype)
    if kind == "linear":
        return PositionwiseFeedForward(idim, linear_units, dropout_rate, activation,
                                       compute_dtype, **kw)
    if kind == "conv1d":
        return MultiLayeredConv1d(idim, linear_units, kernel_size, dropout_rate, compute_dtype,
                                  **kw)
    if kind == "conv1d-linear":
        return Conv1dLinear(idim, linear_units, kernel_size, dropout_rate, compute_dtype, **kw)
    raise ValueError(f"unknown positionwise_layer_type: {kind}")


def _make_pos_enc(kind: str, d: int, dropout_rate: float = 0.1, init_alpha: float = 1.0,
                  device=None):
    """The encoding of ``kind``: ``abs``, ``scaled``, ``rel_pos`` or
    ``legacy_rel_pos`` (the JAX package's ``_make_pos_enc``). The relative
    ones return ``(x, pos_emb)``, the absolute ones ``x``."""
    if kind == "abs":
        return PositionalEncoding(d, dropout_rate)
    if kind == "scaled":
        return ScaledPositionalEncoding(d, dropout_rate, init_alpha, device=device)
    if kind == "rel_pos":
        return RelPositionalEncoding(d, dropout_rate)
    if kind == "legacy_rel_pos":
        return LegacyRelPositionalEncoding(d, dropout_rate)
    raise ValueError(f"unknown pos_enc type: {kind}")


def self_attention(kind: str, n_head: int, size: int, dropout_rate: float,
                   attention_backend: str, flash_min_len: int, compute_dtype,
                   zero_triu: bool = False, rel_scores_bwd: str = "auto", **kw):
    """The self-attention of ``selfattention_layer_type`` ``kind``. The
    standard module (``selfattn``) takes the flash kernels under the
    ``flash`` backend and runs dense under any other, as the JAX package's
    ``MultiHeadedAttention`` does; the relative ones keep the backend and
    take ``zero_triu`` and ``rel_scores_bwd``."""
    common = dict(compute_dtype=compute_dtype, flash_min_len=flash_min_len, **kw)
    if kind == "selfattn":
        backend = "flash" if attention_backend == "flash" else "xla"
        return MultiHeadedAttention(n_head, size, dropout_rate, backend=backend, **common)
    relative = {"rel_selfattn": RelPositionMultiHeadedAttention,
                "legacy_rel_selfattn": LegacyRelPositionMultiHeadedAttention}
    if kind not in relative:
        raise ValueError(f"unknown selfattention_layer_type: {kind}")
    return relative[kind](n_head, size, dropout_rate, zero_triu=zero_triu,
                          backend=attention_backend, rel_scores_bwd=rel_scores_bwd, **common)


class Conv2dSubsampling(torch.nn.Module):
    """Two stride-2 3x3 convs over (time, freq): 1/4 time reduction.

    Reference layout (``conv.0``, ``conv.2``, then the Linear over the
    channel-major flattening). Without ``pos_enc`` the Linear is a bare
    ``out``, as the reference builds it with use_pos_enc=False for AAS-VC's
    duration-predictor projection; with one, ``out`` is the Sequential
    (``out.0`` Linear, ``out.1`` the encoding) of an encoder input layer
    (``torch.nn.Identity`` where the encoding runs after the layer, as the
    conformer's relative one does).
    """

    def __init__(self, idim: int, odim: int, pos_enc: Optional[torch.nn.Module] = None,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv = torch.nn.Sequential(
            torch.nn.Conv2d(1, odim, 3, 2, **kw), torch.nn.ReLU(),
            torch.nn.Conv2d(odim, odim, 3, 2, **kw), torch.nn.ReLU(),
        )
        out = torch.nn.Linear(odim * (((idim - 1) // 2 - 1) // 2), odim, **kw)
        self.out = out if pos_enc is None else torch.nn.Sequential(out, pos_enc)

    def forward(self, x, mask=None):
        h = self.conv(x.float()[:, None])  # (B, C, T', F')
        b, c, t, f = h.shape
        h = self.out(h.transpose(1, 2).reshape(b, t, c * f))
        if mask is not None:
            mask = mask[:, :-2:2][:, :-2:2]
        return h, mask


class EncoderLayer(torch.nn.Module):
    """Pre/post-LN transformer encoder block with standard self-attention
    (the ``selfattn`` type) or relative-position self-attention
    (``rel_selfattn``, ``legacy_rel_selfattn``: the layer then takes the
    encoding's ``pos_emb``, and the relative modules their backend);
    dropout on both residual branches in ``train()`` mode."""

    def __init__(self, size: int, n_head: int, linear_units: int, dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0, normalize_before: bool = True,
                 concat_after: bool = False, positionwise_layer_type: str = "linear",
                 attention_backend: str = "xla", flash_min_len: int = FLASH_MIN_LEN,
                 compute_dtype=None, positionwise_conv_kernel_size: int = 1,
                 selfattention_layer_type: str = "selfattn", device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ln = dict(compute_dtype=compute_dtype, **kw)
        self.dropout_rate = dropout_rate
        self.normalize_before = normalize_before
        self.concat_after = concat_after
        # the relative modules run dense here, as the JAX package builds them
        # in this layer (no backend)
        backend = attention_backend if selfattention_layer_type == "selfattn" else "xla"
        self.self_attn = self_attention(selfattention_layer_type, n_head, size,
                                        attention_dropout_rate, backend, flash_min_len,
                                        compute_dtype, **kw)
        self.feed_forward = _positionwise(positionwise_layer_type, size, linear_units,
                                          dropout_rate, compute_dtype,
                                          kernel_size=positionwise_conv_kernel_size, **kw)
        self.norm1 = LayerNorm(size, LN_EPS, **ln)
        self.norm2 = LayerNorm(size, LN_EPS, **ln)
        if concat_after:
            self.concat_linear = Linear(2 * size, size, **ln)

    def _drop(self, x):
        return F.dropout(x, self.dropout_rate, self.training)

    def forward(self, x, mask, pos_emb=None):
        residual = x
        h = self.norm1(x) if self.normalize_before else x
        if pos_emb is not None:
            att = self.self_attn(h, h, h, pos_emb, mask)
        else:
            att = self.self_attn(h, h, h, mask)
        if self.concat_after:
            x = residual + self.concat_linear(torch.cat([h, att], dim=-1))
        else:
            x = residual + self._drop(att)
        if not self.normalize_before:
            x = self.norm1(x)
        residual = x
        h = self.norm2(x) if self.normalize_before else x
        x = residual + self._drop(self.feed_forward(h))
        if not self.normalize_before:
            x = self.norm2(x)
        return x


class Encoder(torch.nn.Module):
    """Transformer encoder with the ``conv2d-scaled-pos-enc`` or ``conv2d``
    input layer (the VTN's and FastSpeech-VC's encoder: conv2d subsampling,
    then the encoding as ``embed.out.1``), ``linear`` (Linear, LayerNorm
    with eps 1e-5, dropout and ReLU as ``embed.0``-``embed.3``, then the
    encoding ``embed.4``: the reference's layout), ``embed`` (Transformer-TTS:
    a token embedding ``embed.0`` of ``idim`` rows, then the encoding
    ``embed.1``) or none (``None``, FastSpeech-VC's decoder: the encoding
    alone, as ``embed.0``). The encoding is ``pos_enc_type``'s (``scaled``,
    x + alpha * PE and dropout, what every model passes; ``abs``, which
    ``conv2d-scaled-pos-enc`` turns into ``scaled`` as the JAX package
    does; or a relative one, whose table the layers take with a relative
    ``selfattention_layer_type``).

    The embedding has no padding row, as the JAX package's ``nn.Embed``:
    row ``padding_idx`` is initialised and trained as any other (the
    reference's ``padding_idx`` zeroes it; the port follows the JAX
    package, whose parameters it is held against). It is initialised
    normal with standard deviation ``attention_dim ** -0.5``."""

    def __init__(self, idim: int, attention_dim: int = 256, attention_heads: int = 4,
                 linear_units: int = 2048, num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1, attention_dropout_rate: float = 0.0,
                 input_layer: Optional[str] = "conv2d-scaled-pos-enc",
                 normalize_before: bool = True,
                 concat_after: bool = False, positionwise_layer_type: str = "linear",
                 selfattention_layer_type: str = "selfattn", init_enc_alpha: float = 1.0,
                 attention_backend: str = "xla", flash_min_len: int = FLASH_MIN_LEN,
                 compute_dtype=None, positionwise_conv_kernel_size: int = 1,
                 pos_enc_type: str = "scaled", device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.compute_dtype = compute_dtype
        self.input_layer = input_layer
        if input_layer == "conv2d-scaled-pos-enc" and pos_enc_type == "abs":
            pos_enc_type = "scaled"
        pos_enc = _make_pos_enc(pos_enc_type, attention_dim, positional_dropout_rate,
                                init_enc_alpha, device=device)
        if input_layer in ("conv2d-scaled-pos-enc", "conv2d"):
            self.embed = Conv2dSubsampling(idim, attention_dim, pos_enc, **kw)
        elif input_layer == "linear":
            self.embed = torch.nn.Sequential(
                Linear(idim, attention_dim, **kw), LayerNorm(attention_dim, 1e-5, **kw),
                torch.nn.Dropout(dropout_rate), torch.nn.ReLU(), pos_enc)
        elif input_layer == "embed":
            embedding = torch.nn.Embedding(idim, attention_dim, **kw)
            torch.nn.init.normal_(embedding.weight, std=attention_dim ** -0.5)
            self.embed = torch.nn.Sequential(embedding, pos_enc)
        elif input_layer is None:
            self.embed = torch.nn.Sequential(pos_enc)
        else:
            raise ValueError(f"unknown input_layer: {input_layer}")
        self.encoders = torch.nn.ModuleList(
            EncoderLayer(attention_dim, attention_heads, linear_units, dropout_rate,
                         attention_dropout_rate, normalize_before, concat_after,
                         positionwise_layer_type, attention_backend, flash_min_len,
                         compute_dtype, positionwise_conv_kernel_size,
                         selfattention_layer_type, **kw)
            for _ in range(num_blocks)
        )
        self.normalize_before = normalize_before
        if normalize_before:
            self.after_norm = LayerNorm(attention_dim, LN_EPS, compute_dtype, **kw)

    @property
    def conv_subsampling_factor(self) -> int:
        return 4 if self.input_layer in ("conv2d", "conv2d-scaled-pos-enc") else 1

    def forward(self, xs, masks: Optional[torch.Tensor]):
        """xs: (B, T, idim), or (B, T) integer tokens for ``embed``; masks:
        (B, T) non-pad. Returns the float32 (B, T', adim) states and the
        (subsampled) (B, T') mask."""
        if self.conv_subsampling_factor == 4:
            xs, masks = self.embed(xs, masks)
        else:
            xs = self.embed(xs)
        xs, pos_emb = xs if isinstance(xs, tuple) else (xs, None)
        if self.compute_dtype is not None:
            xs = xs.to(self.compute_dtype)
        attn_mask = None if masks is None else masks[:, None, :]
        for layer in self.encoders:
            xs = layer(xs, attn_mask, pos_emb)
        if self.normalize_before:
            xs = self.after_norm(xs)
        return xs.float(), masks


class DecoderLayer(torch.nn.Module):
    """Masked self-attention + cross-attention + FFN (pre/post-LN)."""

    def __init__(self, size: int, n_head: int, linear_units: int, dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0, normalize_before: bool = True,
                 concat_after: bool = False, compute_dtype=None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ln = dict(compute_dtype=compute_dtype, **kw)
        self.n_head = n_head
        self.dropout_rate = dropout_rate
        self.normalize_before = normalize_before
        self.concat_after = concat_after
        self.self_attn = MultiHeadedAttention(n_head, size, self_attention_dropout_rate, **ln)
        self.src_attn = MultiHeadedAttention(n_head, size, src_attention_dropout_rate, **ln)
        self.feed_forward = PositionwiseFeedForward(size, linear_units, dropout_rate,
                                                    compute_dtype=compute_dtype, **kw)
        self.norm1 = LayerNorm(size, LN_EPS, **ln)
        self.norm2 = LayerNorm(size, LN_EPS, **ln)
        self.norm3 = LayerNorm(size, LN_EPS, **ln)
        if concat_after:
            self.concat_linear1 = Linear(2 * size, size, **ln)
            self.concat_linear2 = Linear(2 * size, size, **ln)

    def _drop(self, x):
        return F.dropout(x, self.dropout_rate, self.training)

    def forward(self, tgt, tgt_mask, memory, memory_mask, return_attns: bool = False):
        """Teacher forcing. tgt_mask (B, T, T); memory_mask (B, 1, Tmem).
        With ``return_attns``, also the cross-attention weights."""
        residual = tgt
        x = self.norm1(tgt) if self.normalize_before else tgt
        sa = self.self_attn(x, x, x, tgt_mask)
        if self.concat_after:
            x = residual + self.concat_linear1(torch.cat([x, sa], dim=-1))
        else:
            x = residual + self._drop(sa)
        if not self.normalize_before:
            x = self.norm1(x)

        residual = x
        h = self.norm2(x) if self.normalize_before else x
        ca = self.src_attn(h, memory, memory, memory_mask, return_weights=return_attns)
        ca, ca_w = ca if return_attns else (ca, None)
        if self.concat_after:
            x = residual + self.concat_linear2(torch.cat([h, ca], dim=-1))
        else:
            x = residual + self._drop(ca)
        if not self.normalize_before:
            x = self.norm2(x)

        residual = x
        f = self.norm3(x) if self.normalize_before else x
        x = residual + self._drop(self.feed_forward(f))
        if not self.normalize_before:
            x = self.norm3(x)
        return (x, ca_w) if return_attns else x

    def step(self, x_t, t: int, k_cache, v_cache, mem_k, mem_v, memory_mask):
        """One decode step. x_t: (B, 1, size); k_cache, v_cache: (B, H,
        maxlen, d_k), entry t written here in place; mem_k, mem_v: (B, H,
        Tmem, d_k); memory_mask: (B, Tmem) or None. Returns (y_t (B, 1,
        size), cross-attention weights (B, H, 1, Tmem)). With ``concat_after``
        the step applies ``concat_linear1``/``concat_linear2`` as the
        teacher-forced ``forward`` does (the JAX package's step leaves them
        out, so its decode is not the function its model trains; ROADMAP.md
        §3)."""
        residual = x_t
        x = self.norm1(x_t) if self.normalize_before else x_t
        k_new, v_new = self.self_attn.project_kv(x, x)
        k_cache[:, :, t] = k_new[:, :, 0]
        v_cache[:, :, t] = v_new[:, :, 0]
        sa = self.self_attn.attend_with_kv(x, k_cache[:, :, :t + 1], v_cache[:, :, :t + 1])
        if self.concat_after:
            x = residual + self.concat_linear1(torch.cat([x, sa], dim=-1))
        else:
            x = residual + sa
        if not self.normalize_before:
            x = self.norm1(x)

        residual = x
        h = self.norm2(x) if self.normalize_before else x
        mmask = None if memory_mask is None else memory_mask[:, None, None, :]
        ca, ca_w = self.src_attn.attend_with_kv(h, mem_k, mem_v, mmask, return_weights=True)
        if self.concat_after:
            x = residual + self.concat_linear2(torch.cat([h, ca], dim=-1))
        else:
            x = residual + ca
        if not self.normalize_before:
            x = self.norm2(x)

        residual = x
        f = self.norm3(x) if self.normalize_before else x
        x = residual + self.feed_forward(f)
        if not self.normalize_before:
            x = self.norm3(x)
        return x, ca_w


class Decoder(torch.nn.Module):
    """Transformer decoder whose input layer is the caller's ``prenet`` (a
    module taking ``(x, generator)``, e.g. the VTN's Prenet and projection)
    followed by the scaled positional encoding: ``embed.0`` and
    ``embed.1``, the reference's names. No output layer."""

    def __init__(self, prenet: torch.nn.Module, attention_dim: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048, num_blocks: int = 6,
                 dropout_rate: float = 0.1, positional_dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0, normalize_before: bool = True,
                 concat_after: bool = False, init_dec_alpha: float = 1.0,
                 compute_dtype=None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.compute_dtype = compute_dtype
        self.attention_heads = attention_heads
        self.embed = torch.nn.Sequential(
            prenet,
            ScaledPositionalEncoding(attention_dim, positional_dropout_rate, init_dec_alpha,
                                     device=device),
        )
        self.decoders = torch.nn.ModuleList(
            DecoderLayer(attention_dim, attention_heads, linear_units, dropout_rate,
                         self_attention_dropout_rate, src_attention_dropout_rate,
                         normalize_before, concat_after, compute_dtype, **kw)
            for _ in range(num_blocks)
        )
        self.normalize_before = normalize_before
        if normalize_before:
            self.after_norm = LayerNorm(attention_dim, LN_EPS, compute_dtype, **kw)

    def _finish(self, x):
        if self.normalize_before:
            x = self.after_norm(x)
        return x.float()

    def forward(self, tgt, tgt_mask, memory, memory_mask, return_attns: bool = False,
                generator=None):
        """Teacher forcing. tgt: (B, T, odim) decoder inputs (before the
        prenet); tgt_mask: (B, T, T); memory: (B, Tmem, adim); memory_mask:
        (B, Tmem) non-pad. Returns the float32 (B, T, adim) states and, with
        ``return_attns``, the list of cross-attention weights per layer."""
        x = self.embed[1](self.embed[0](tgt, generator))
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        mem_mask = None if memory_mask is None else memory_mask[:, None, :]
        src_ws = []
        for layer in self.decoders:
            x = layer(x, tgt_mask, memory, mem_mask, return_attns=return_attns)
            if return_attns:
                x, w = x
                src_ws.append(w)
        x = self._finish(x)
        return (x, src_ws) if return_attns else x

    def init_cache(self, batch: int, maxlen: int, device=None) -> Dict[str, List[torch.Tensor]]:
        """Per-layer (B, H, maxlen, d_k) self-attention caches (H: the heads
        this rank holds)."""
        att = self.decoders[0].self_attn
        shape = (batch, att.n_head, maxlen, att.d_k)
        dt = self.compute_dtype or torch.float32
        return {key: [torch.zeros(shape, dtype=dt, device=device) for _ in self.decoders]
                for key in ("k", "v")}

    def precompute_memory(self, memory) -> Dict[str, List[torch.Tensor]]:
        """Cross-attention K/V, projected once per utterance."""
        kv = [layer.src_attn.project_kv(memory, memory) for layer in self.decoders]
        return {"mk": [k for k, _ in kv], "mv": [v for _, v in kv]}

    def step(self, y_t, t: int, cache, mem_kv, memory_mask=None):
        """One AR step. y_t: (B, 1, adim) input frame after the prenet; the
        positional encoding of index t is added here. Returns (z_t (B,
        adim) float32, cross-attention weights (L, B, H, 1, Tmem))."""
        x = self.embed[1].encode_at(y_t, t, cache["k"][0].shape[2])
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        cross = []
        for i, layer in enumerate(self.decoders):
            x, w = layer.step(x, t, cache["k"][i], cache["v"][i], mem_kv["mk"][i],
                              mem_kv["mv"][i], memory_mask)
            cross.append(w)
        return self._finish(x)[:, 0], torch.stack(cross)
