"""Transformer-TTS, text to mel (mirrors
seq2seq_vc_tpu/models/transformer_tts.py: ``_add_eos``, ``encode``,
``__call__`` and ``inference``).

A token-embedding transformer encoder (``input_layer="embed"``) over the
text with an eos token appended at each item's length (eos = ``idim - 1``,
padding 0), then the VTN's decoder side: Tacotron prenet and projection,
transformer decoder with reduction factor r, feature and stop heads, conv
postnet (``vtn.ar_decoder_modules``). ``forward`` is the teacher-forced
training pass; its ``att_ws`` are the cross-attention maps of the first
``num_heads_applied_guided_attn`` heads of the last
``num_layers_applied_guided_attn`` layers, concatenated along the head
axis, which the guided-attention loss reads. ``inference`` and the chunked
decode (``models/chunked_decode.py``) run through ``encode``, so the
decoder's memory holds the eos and its lengths count it.

The model runs no kernel of its own, as in the JAX package, whose model
has no attention backend: every attention is dense. Speaker embeddings
(``spk_embed_dim``, ``add`` or ``concat``) join the encoder states after
the eos, as in the VTN; the positionwise layer takes its three kinds and
the postnet its group or batch norm. Submodule names are the reference
torch names (``encoder.embed.0`` the embedding, ``encoder.embed.1.alpha``,
``decoder.embed.0.0``/``.0.1`` the prenet and its projection), so a
``state_dict`` converts with
``seq2seq_vc_tpu/convert/reference.py:convert_transformer_tts``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..nn.transformer import Encoder
from ..ops.masks import make_non_pad_mask
from .common import speaker_projection
from .vtn import ARSeq2Seq, ar_decoder_modules


class TransformerTTS(ARSeq2Seq):
    def __init__(
        self,
        idim: int,
        odim: int,
        embed_dim: int = 512,  # read by no module, as in the JAX model
        dprenet_layers: int = 2,
        dprenet_units: int = 256,
        adim: int = 384,
        aheads: int = 4,
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
        decoder_reduction_factor: int = 1,
        spk_embed_dim: Optional[int] = None,
        spk_embed_integration_type: str = "add",
        initial_encoder_alpha: float = 1.0,
        initial_decoder_alpha: float = 1.0,
        use_guided_attn_loss: bool = False,
        num_heads_applied_guided_attn: int = 2,
        num_layers_applied_guided_attn: int = 2,
        init_type: str = "xavier_uniform",
        postnet_norm_type: str = "group_norm",
        device=None,
    ):
        super().__init__()
        self.idim, self.odim, self.adim = idim, odim, adim
        self.spk_embed_integration_type = spk_embed_integration_type
        self.decoder_reduction_factor = r = decoder_reduction_factor
        self.num_heads_applied_guided_attn = num_heads_applied_guided_attn
        self.num_layers_applied_guided_attn = num_layers_applied_guided_attn
        self.encoder = Encoder(
            idim, attention_dim=adim, attention_heads=aheads, linear_units=eunits,
            num_blocks=elayers, dropout_rate=transformer_enc_dropout_rate,
            positional_dropout_rate=transformer_enc_positional_dropout_rate,
            attention_dropout_rate=transformer_enc_attn_dropout_rate, input_layer="embed",
            normalize_before=encoder_normalize_before, concat_after=encoder_concat_after,
            positionwise_layer_type=positionwise_layer_type,
            positionwise_conv_kernel_size=positionwise_conv_kernel_size,
            init_enc_alpha=initial_encoder_alpha, device=device,
        )
        self.projection = speaker_projection(spk_embed_dim, spk_embed_integration_type, adim,
                                             device)
        self.decoder, self.feat_out, self.prob_out, self.postnet = ar_decoder_modules(
            odim, adim, aheads, dprenet_layers, dprenet_units, dprenet_dropout_rate, dlayers,
            dunits, transformer_dec_dropout_rate, transformer_dec_positional_dropout_rate,
            transformer_dec_attn_dropout_rate, decoder_normalize_before, decoder_concat_after,
            initial_decoder_alpha, r, postnet_layers, postnet_chans, postnet_filts,
            use_batch_norm, device=device, postnet_norm_type=postnet_norm_type)

    @property
    def padding_idx(self) -> int:
        return 0

    @property
    def eos(self) -> int:
        return self.idim - 1

    def _add_eos(self, xs, ilens):
        """Append eos at position ilens[b] (reference ``transformer_tts.py:138-142``).
        xs: (B, T) integer tokens; returns (B, T + 1) tokens and ilens + 1."""
        xs = F.pad(xs, (0, 1), value=self.padding_idx)
        pos = torch.arange(xs.shape[1], device=xs.device)[None, :]
        return torch.where(pos == ilens[:, None], self.eos, xs), ilens + 1

    def encode(self, xs, ilens, spembs=None):
        """(B, T + 1, adim) float32 encoder states of the tokens with eos
        appended, with the speaker embeddings ``spembs`` (B, spk_embed_dim)
        where the model has them, and their (B, T + 1) mask."""
        xs, ilens = self._add_eos(xs, ilens)
        hs, h_masks = self.encoder(xs, make_non_pad_mask(ilens, xs.shape[1]))
        return self._with_speaker(hs, spembs), h_masks

    def forward(self, xs, ilens, ys, labels, olens,
                generator: Optional[torch.Generator] = None, spembs=None) -> Dict[str, Any]:
        """Teacher-forced forward. xs: (B, T) integer tokens; ilens: (B,);
        ys: (B, Lmax, odim) targets, Lmax a multiple of r; labels: (B, Lmax)
        stop labels; olens: (B,). ``att_ws`` is (B, H' * L', Lmax // r, T +
        1) for the selected heads and layers; ``ilens`` counts the eos.
        ``generator`` draws the prenet's dropout; ``spembs`` (B,
        spk_embed_dim) are the speaker embeddings, with ``spk_embed_dim``."""
        hs, h_masks = self.encode(xs, ilens, spembs)
        out = self.decode_teacher_forced(hs, h_masks, ys, labels, olens, True, generator)
        sel = out.pop("src_ws")[-self.num_layers_applied_guided_attn:]
        out["att_ws"] = torch.cat([w[:, :self.num_heads_applied_guided_attn] for w in sel],
                                  dim=1)
        out["ilens"] = ilens + 1
        return out
