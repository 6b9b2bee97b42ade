"""Voice Transformer Network, the AR mel-to-mel VC model (mirrors
seq2seq_vc_tpu/models/vtn.py: ``setup``, ``encode``, ``__call__`` and
``inference``).

Conv2d-subsampled transformer encoder (its self-attention on the flash
kernels from ``flash_min_len`` keys under ``attention_backend: flash``) or
conformer encoder (``encoder_type: conformer``: conv2d subsampling, then
relative-position layers, new style or legacy by
``conformer_rel_pos_type``, routed as AAS-VC's: the fused or flash rel-pos
kernels by ``attention_backend``; the JAX model builds that encoder on the
dense route, the same function), speaker embeddings (``spk_embed_dim``,
``add`` or ``concat``), Tacotron prenet and transformer decoder with
reduction factor r, feature and stop heads, conv postnet (group or batch
norm). ``forward`` is the teacher-forced training pass; ``inference``
decodes autoregressively with per-layer K/V caches
(``models/chunked_decode.py``). The constructor takes the JAX model's
config fields by the same names and defaults; other input layers and
decoder types raise ``NotImplementedError``. Submodule names are the
reference torch names (the decoder's prenet and projection are
``decoder.embed.0.0`` and ``decoder.embed.0.1``, its alpha
``decoder.embed.1.alpha``), so a ``state_dict`` converts with
``seq2seq_vc_tpu/convert/reference.py:convert_vtn``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..nn.attention import FLASH_MIN_LEN
from ..nn.conformer import ConformerEncoder
from ..nn.layers import Linear
from ..nn.pre_postnets import Postnet, Prenet
from ..nn.transformer import Decoder, Encoder
from ..ops.masks import make_non_pad_mask, target_mask
from .aas_vc import _conformer_types
from .chunked_decode import ChunkedARDecodeMixin
from .common import integrate_spk_embed, speaker_projection

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class _PrenetProjection(torch.nn.Sequential):
    """The decoder's input layer: Prenet (``0``) then the projection to
    adim (``1``); the prenet's dropout draws from ``generator``."""

    def forward(self, x, generator=None):
        return self[1](self[0](x, generator))


def ar_decoder_modules(odim, adim, aheads, dprenet_layers, dprenet_units, dprenet_dropout_rate,
                       dlayers, dunits, dropout_rate, positional_dropout_rate,
                       attn_dropout_rate, normalize_before, concat_after, init_alpha, r,
                       postnet_layers, postnet_chans, postnet_filts, use_batch_norm,
                       compute_dtype=None, device=None, postnet_norm_type="group_norm"):
    """The decoder side that the VTN and Transformer-TTS share: (decoder
    with its prenet and projection, ``feat_out``, ``prob_out``, postnet or
    None without postnet layers)."""
    prenet = _PrenetProjection(
        Prenet(odim, dprenet_layers, dprenet_units, dprenet_dropout_rate, device=device),
        Linear(dprenet_units, adim, device=device),
    )
    decoder = Decoder(
        prenet, attention_dim=adim, attention_heads=aheads, linear_units=dunits,
        num_blocks=dlayers, dropout_rate=dropout_rate,
        positional_dropout_rate=positional_dropout_rate,
        self_attention_dropout_rate=attn_dropout_rate,
        src_attention_dropout_rate=attn_dropout_rate, normalize_before=normalize_before,
        concat_after=concat_after, init_dec_alpha=init_alpha, compute_dtype=compute_dtype,
        device=device,
    )
    postnet = (Postnet(odim, postnet_layers, postnet_chans, postnet_filts,
                       use_norm=use_batch_norm, norm_type=postnet_norm_type, device=device)
               if postnet_layers > 0 else None)
    return (decoder, Linear(adim, odim * r, device=device), Linear(adim, r, device=device),
            postnet)


class ARSeq2Seq(ChunkedARDecodeMixin, torch.nn.Module):
    """What the VTN and Transformer-TTS share past their encoders: the
    prenet accessors that the chunked decode reads, the teacher-forced
    decoder pass, the speaker embeddings and the one-loop ``inference``. A
    subclass builds ``decoder``, ``feat_out``, ``prob_out``, ``postnet``
    (``ar_decoder_modules``) and ``projection`` (``speaker_projection``)
    and defines ``encode(xs, ilens, spembs=None)``."""

    def _with_speaker(self, hs, spembs):
        if self.projection is None:
            return hs
        return integrate_spk_embed(self.projection, self.spk_embed_integration_type, hs, spembs)

    @property
    def dprenet(self) -> Prenet:
        return self.decoder.embed[0][0]

    @property
    def dprenet_proj(self) -> Linear:
        return self.decoder.embed[0][1]

    def decode_teacher_forced(self, hs, h_masks, ys, labels, olens, need_att_ws: bool,
                              generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """The decoder side of the teacher-forced forward on encoder states
        ``hs`` (B, Tmem, adim) and their mask. ys: (B, Lmax, odim) targets,
        Lmax a multiple of r; labels: (B, Lmax) stop labels; olens: (B,).
        With ``need_att_ws`` the per-layer (B, H, Lmax // r, Tmem)
        cross-attention maps are returned as ``src_ws``."""
        r = self.decoder_reduction_factor
        B, Lmax, _ = ys.shape
        if Lmax % r:
            raise ValueError(f"target length {Lmax} is not a multiple of r = {r}")
        # every r-th frame (the last of each group), shifted right
        ys_in = ys[:, r - 1::r]
        olens_in = torch.div(olens, r, rounding_mode="floor")
        ys_in = torch.cat([torch.zeros_like(ys_in[:, :1]), ys_in[:, :-1]], dim=1)
        y_masks = target_mask(olens_in, ys_in.shape[1])
        zs = self.decoder(ys_in, y_masks, hs, h_masks, return_attns=need_att_ws,
                          generator=generator)
        zs, src_ws = zs if need_att_ws else (zs, None)
        before_outs = self.feat_out(zs).reshape(B, -1, self.odim)
        logits = self.prob_out(zs).reshape(B, -1)
        after_outs = before_outs if self.postnet is None else before_outs + self.postnet(before_outs)
        # targets and stop labels adjusted for the truncated tail (reference vtn.py:262-274)
        olens_adj = olens - olens % r
        pos = torch.arange(Lmax, device=ys.device)[None, :]
        labels_adj = torch.where(pos == (olens_adj - 1)[:, None], 1.0, labels)
        return {"after_outs": after_outs, "before_outs": before_outs, "logits": logits,
                "ys": ys, "labels": labels_adj, "olens": olens_adj, "olens_in": olens_in,
                "src_ws": src_ws}

    @torch.no_grad()
    def inference(self, xs, ilens, generator: Optional[torch.Generator] = None,
                  threshold: float = 0.5, minlenratio: float = 0.0,
                  maxlenratio: float = 10.0, spembs=None) -> Dict[str, Any]:
        """Batched AR decode over the whole step budget in one loop, with
        per-item stop thresholds and min/max length ratios; ``spembs`` (B,
        spk_embed_dim) with speaker embeddings.

        Returns outs (B, MAXLEN*r, odim) postnet-refined features, probs (B,
        MAXLEN*r) stop probabilities, out_lens (B,) valid output frames and
        att_ws (L, B, H, MAXLEN, Tmem) cross-attention maps."""
        st = self.decode_init(xs, ilens, maxlenratio, spembs=spembs)
        st, outs, probs, att = self.decode_chunk(st, 0, st["maxlen"], threshold, minlenratio,
                                                 maxlenratio, generator)
        out_lens = self.decode_out_lens(st, maxlenratio)
        return {"outs": self.decode_postnet(outs, out_lens), "probs": probs,
                "out_lens": out_lens, "att_ws": att}


class VTN(ARSeq2Seq):
    def __init__(
        self,
        idim: int,
        odim: int,
        dprenet_layers: int = 2,
        dprenet_units: int = 256,
        adim: int = 384,
        aheads: int = 4,
        encoder_type: str = "transformer",
        decoder_type: str = "transformer",
        elayers: int = 6,
        eunits: int = 1536,
        dlayers: int = 6,
        dunits: int = 1536,
        postnet_layers: int = 5,
        postnet_filts: int = 5,
        postnet_chans: int = 256,
        positionwise_layer_type: str = "linear",
        positionwise_conv_kernel_size: int = 1,
        dprenet_dropout_rate: float = 0.5,
        transformer_enc_dropout_rate: float = 0.1,
        transformer_enc_positional_dropout_rate: float = 0.1,
        transformer_enc_attn_dropout_rate: float = 0.1,
        transformer_dec_dropout_rate: float = 0.1,
        transformer_dec_positional_dropout_rate: float = 0.1,
        transformer_dec_attn_dropout_rate: float = 0.1,
        use_batch_norm: bool = True,
        encoder_normalize_before: bool = True,
        decoder_normalize_before: bool = False,
        encoder_concat_after: bool = False,
        decoder_concat_after: bool = False,
        decoder_reduction_factor: int = 2,
        encoder_input_layer: str = "conv2d-scaled-pos-enc",
        spk_embed_dim: Optional[int] = None,
        spk_embed_integration_type: str = "add",
        initial_encoder_alpha: float = 1.0,
        initial_decoder_alpha: float = 1.0,
        conformer_rel_pos_type: str = "legacy",
        conformer_pos_enc_layer_type: str = "rel_pos",
        conformer_self_attn_layer_type: str = "rel_selfattn",
        use_macaron_style_in_conformer: bool = True,
        use_cnn_in_conformer: bool = True,
        zero_triu: bool = False,
        conformer_enc_kernel_size: int = 7,
        conformer_conv_norm_type: str = "group_norm",
        postnet_norm_type: str = "group_norm",
        attention_backend: str = "xla",
        flash_min_len: int = FLASH_MIN_LEN,
        rel_scores_bwd: str = "auto",
        compute_dtype: str = "float32",
        device=None,
        **unread: Any,
    ):
        """Config fields that the model does not read (init, guided
        attention, ``conformer_dec_kernel_size``, and the conformer options
        with the transformer encoder) are accepted in ``unread`` and
        ignored. ``flash_min_len`` is the encoder's flash gate
        (``nn/attention.py``); ``rel_scores_bwd`` the conformer encoder's
        fused backward variant (``ops/rel_scores.py``)."""
        super().__init__()
        unsupported = {
            "decoder_type": (decoder_type, "transformer"),
            "encoder_input_layer": (encoder_input_layer, "conv2d-scaled-pos-enc"),
        }
        for key, (got, want) in unsupported.items():
            if got != want:
                raise NotImplementedError(f"VTN {key}={got!r} is not ported yet")
        self.idim, self.odim, self.adim = idim, odim, adim
        self.decoder_reduction_factor = r = decoder_reduction_factor
        self.spk_embed_integration_type = spk_embed_integration_type
        cdt = _DTYPES[compute_dtype]
        enc = dict(attention_dim=adim, attention_heads=aheads, linear_units=eunits,
                   num_blocks=elayers, dropout_rate=transformer_enc_dropout_rate,
                   positional_dropout_rate=transformer_enc_positional_dropout_rate,
                   attention_dropout_rate=transformer_enc_attn_dropout_rate,
                   normalize_before=encoder_normalize_before, concat_after=encoder_concat_after,
                   positionwise_layer_type=positionwise_layer_type,
                   positionwise_conv_kernel_size=positionwise_conv_kernel_size,
                   attention_backend=attention_backend, flash_min_len=flash_min_len,
                   compute_dtype=cdt, device=device)
        if encoder_type == "transformer":
            self.encoder = Encoder(idim, input_layer=encoder_input_layer,
                                   init_enc_alpha=initial_encoder_alpha, **enc)
        elif encoder_type == "conformer":
            pos_enc, self_attn = _conformer_types(conformer_rel_pos_type,
                                                  conformer_pos_enc_layer_type,
                                                  conformer_self_attn_layer_type)
            self.encoder = ConformerEncoder(
                idim, input_layer="conv2d", macaron_style=use_macaron_style_in_conformer,
                pos_enc_layer_type=pos_enc, selfattention_layer_type=self_attn,
                use_cnn_module=use_cnn_in_conformer, cnn_module_kernel=conformer_enc_kernel_size,
                conv_norm_type=conformer_conv_norm_type, zero_triu=zero_triu,
                rel_scores_bwd=rel_scores_bwd, **enc)
        else:
            raise NotImplementedError(f"VTN encoder_type={encoder_type!r}")
        self.projection = speaker_projection(spk_embed_dim, spk_embed_integration_type, adim,
                                             device)
        self.decoder, self.feat_out, self.prob_out, self.postnet = ar_decoder_modules(
            odim, adim, aheads, dprenet_layers, dprenet_units, dprenet_dropout_rate, dlayers,
            dunits, transformer_dec_dropout_rate, transformer_dec_positional_dropout_rate,
            transformer_dec_attn_dropout_rate, decoder_normalize_before, decoder_concat_after,
            initial_decoder_alpha, r, postnet_layers, postnet_chans, postnet_filts,
            use_batch_norm, cdt, device, postnet_norm_type)

    def encode(self, xs, ilens, spembs=None):
        """(B, T', adim) float32 encoder states, with the speaker embeddings
        ``spembs`` (B, spk_embed_dim) where the model has them, and their
        (B, T') mask."""
        hs, h_masks = self.encoder(xs, make_non_pad_mask(ilens, xs.shape[1]))
        return self._with_speaker(hs, spembs), h_masks

    def forward(self, xs, ilens, ys, labels, olens, need_att_ws: bool = False,
                generator: Optional[torch.Generator] = None, spembs=None) -> Dict[str, Any]:
        """Teacher-forced forward (reference ``vtn.py:207-300``).

        xs: (B, Tin, idim) source features; ilens: (B,); ys: (B, Lmax, odim)
        targets, Lmax a multiple of r; labels: (B, Lmax) stop labels; olens:
        (B,). The (L, B, H, Lmax // r, Tmem) cross-attention maps
        (``att_ws``) are built only with ``need_att_ws``: at long lengths
        they are the largest tensors of the step. ``generator`` draws the
        prenet's dropout (default: torch's default generator); ``spembs``
        (B, spk_embed_dim) are the speaker embeddings, with ``spk_embed_dim``.
        """
        hs, h_masks = self.encode(xs, ilens, spembs)
        out = self.decode_teacher_forced(hs, h_masks, ys, labels, olens, need_att_ws, generator)
        src_ws = out.pop("src_ws")
        out["ilens_ds_st"] = torch.div(torch.div(ilens - 1, 2, rounding_mode="floor") - 1, 2,
                                       rounding_mode="floor")
        if need_att_ws:
            out["att_ws"] = torch.stack(src_ws)
        return out
