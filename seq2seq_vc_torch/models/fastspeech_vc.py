"""FastSpeech-VC, the NAR model trained on teacher durations (mirrors
seq2seq_vc_tpu/models/fastspeech_vc.py: ``setup``, ``_encode``,
``_dp_features``, ``__call__`` and ``inference``).

A transformer encoder (conv2d subsampling with the scaled encoding) or a
conformer encoder (``linear`` or ``conv2d`` input layer, relative
positions) -> the deterministic duration predictor, on the encoder states
or on a separate conv2d projection of the source features -> the hard
length regulator, with the teacher durations scaled by
``teacher_model_decoder_reduction_factor`` -> the same kind of stack as
decoder (no input layer) -> ``feat_out`` -> postnet. The JAX model passes
its attention backend to the conformer stacks only: the transformer stacks
stay dense. The constructor takes the JAX model's config fields by the
same names and defaults: the positionwise layer's three kinds, speaker
embeddings (``spk_embed_dim``, ``add`` or ``concat``; ``spembs`` to
``forward`` and ``inference``), the group- or batch-norm postnet and conv
module. Submodule names are the reference torch names, so
a ``state_dict`` converts with
``seq2seq_vc_tpu/convert/reference.py:convert_fastspeech_vc``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..nn.attention import FLASH_MIN_LEN
from ..nn.conformer import ConformerEncoder
from ..nn.duration_predictor import DurationPredictor
from ..nn.layers import Linear
from ..nn.pre_postnets import Postnet
from ..nn.transformer import Conv2dSubsampling, Encoder
from ..ops.masks import make_non_pad_mask
from ..ops.upsampling import length_regulator
from .aas_vc import _DTYPES, _conformer_types
from .common import (
    conv2d_subsampled_lengths,
    integrate_spk_embed,
    nearest_interpolate,
    reduce_frames,
    speaker_projection,
)


class FastSpeechVC(torch.nn.Module):
    def __init__(
        self,
        idim: int,
        odim: int,
        adim: int = 384,
        aheads: int = 4,
        elayers: int = 6,
        eunits: int = 1536,
        dlayers: int = 6,
        dunits: int = 1536,
        postnet_layers: int = 5,
        postnet_chans: int = 512,
        postnet_filts: int = 5,
        positionwise_layer_type: str = "conv1d",
        positionwise_conv_kernel_size: int = 1,
        use_batch_norm: bool = True,
        encoder_input_layer: str = "linear",
        encoder_normalize_before: bool = False,
        decoder_normalize_before: bool = False,
        encoder_concat_after: bool = False,
        decoder_concat_after: bool = False,
        duration_predictor_use_encoder_outputs: bool = True,
        duration_predictor_input_dim: Optional[int] = None,
        duration_predictor_layers: int = 2,
        duration_predictor_chans: int = 384,
        duration_predictor_kernel_size: int = 3,
        encoder_reduction_factor: int = 1,
        decoder_reduction_factor: int = 1,
        encoder_type: str = "transformer",
        decoder_type: str = "transformer",
        conformer_rel_pos_type: str = "latest",
        conformer_pos_enc_layer_type: str = "rel_pos",
        conformer_self_attn_layer_type: str = "rel_selfattn",
        use_macaron_style_in_conformer: bool = True,
        use_cnn_in_conformer: bool = True,
        conformer_enc_kernel_size: int = 7,
        conformer_dec_kernel_size: int = 31,
        spk_embed_dim: Optional[int] = None,
        spk_embed_integration_type: str = "add",
        transformer_enc_dropout_rate: float = 0.1,
        transformer_enc_positional_dropout_rate: float = 0.1,
        transformer_enc_attn_dropout_rate: float = 0.1,
        transformer_dec_dropout_rate: float = 0.1,
        transformer_dec_positional_dropout_rate: float = 0.1,
        transformer_dec_attn_dropout_rate: float = 0.1,
        duration_predictor_dropout_rate: float = 0.1,
        postnet_dropout_rate: float = 0.5,
        init_enc_alpha: float = 1.0,
        init_dec_alpha: float = 1.0,
        conformer_conv_norm_type: str = "group_norm",
        postnet_norm_type: str = "group_norm",
        attention_backend: str = "xla",
        teacher_model_decoder_reduction_factor: int = 4,
        flash_min_len: int = FLASH_MIN_LEN,
        rel_scores_bwd: str = "auto",
        compute_dtype: str = "float32",
        device=None,
        **unread: Any,
    ):
        """Config fields that the model does not read (loss and init
        options) are accepted in ``unread`` and ignored. ``flash_min_len``,
        ``rel_scores_bwd`` and ``compute_dtype`` are AASVC's options of the
        conformer stacks; ``compute_dtype`` runs the transformer stacks in
        that type too."""
        super().__init__()
        for key, kind in (("encoder_type", encoder_type), ("decoder_type", decoder_type)):
            if kind not in ("transformer", "conformer"):
                raise ValueError(f"unknown {key}: {kind}")
        self.idim, self.odim, self.adim = idim, odim, adim
        self.encoder_type = encoder_type
        self.encoder_input_layer = encoder_input_layer
        self.encoder_reduction_factor = encoder_reduction_factor
        self.decoder_reduction_factor = decoder_reduction_factor
        self.teacher_model_decoder_reduction_factor = teacher_model_decoder_reduction_factor
        self.duration_predictor_use_encoder_outputs = duration_predictor_use_encoder_outputs
        self.spk_embed_integration_type = spk_embed_integration_type
        cdt = _DTYPES[compute_dtype]
        pw = dict(positionwise_layer_type=positionwise_layer_type,
                  positionwise_conv_kernel_size=positionwise_conv_kernel_size)
        pos_enc, self_attn = _conformer_types(conformer_rel_pos_type, conformer_pos_enc_layer_type,
                                              conformer_self_attn_layer_type)
        conformer = dict(
            attention_heads=aheads, macaron_style=use_macaron_style_in_conformer,
            pos_enc_layer_type=pos_enc, selfattention_layer_type=self_attn,
            use_cnn_module=use_cnn_in_conformer, conv_norm_type=conformer_conv_norm_type, attention_backend=attention_backend,
            flash_min_len=flash_min_len, rel_scores_bwd=rel_scores_bwd, compute_dtype=cdt,
            device=device, **pw,
        )
        # the JAX model gives its transformer stacks only the residual
        # dropout rate: the positional and attention rates stay at the
        # encoder's defaults, and the attention stays dense
        transformer = dict(attention_heads=aheads, compute_dtype=cdt, device=device, **pw)
        if encoder_type == "transformer":
            self.encoder = Encoder(
                idim, attention_dim=adim, linear_units=eunits, num_blocks=elayers,
                input_layer="conv2d-scaled-pos-enc", normalize_before=encoder_normalize_before,
                concat_after=encoder_concat_after, dropout_rate=transformer_enc_dropout_rate,
                init_enc_alpha=init_enc_alpha, **transformer,
            )
        else:
            self.encoder = ConformerEncoder(
                idim * encoder_reduction_factor, attention_dim=adim, linear_units=eunits,
                num_blocks=elayers, dropout_rate=transformer_enc_dropout_rate,
                positional_dropout_rate=transformer_enc_positional_dropout_rate,
                attention_dropout_rate=transformer_enc_attn_dropout_rate,
                input_layer=encoder_input_layer, normalize_before=encoder_normalize_before,
                concat_after=encoder_concat_after, cnn_module_kernel=conformer_enc_kernel_size,
                **conformer,
            )
        self.projection = speaker_projection(spk_embed_dim, spk_embed_integration_type, adim,
                                             device)
        self.duration_predictor = DurationPredictor(
            adim, duration_predictor_layers, duration_predictor_chans,
            duration_predictor_kernel_size, duration_predictor_dropout_rate, device=device,
        )
        if not duration_predictor_use_encoder_outputs:
            self.duration_predictor_projection = Conv2dSubsampling(
                duration_predictor_input_dim or idim, adim, device=device,
            )
        if decoder_type == "transformer":
            self.decoder = Encoder(
                0, attention_dim=adim, linear_units=dunits, num_blocks=dlayers, input_layer=None,
                normalize_before=decoder_normalize_before, concat_after=decoder_concat_after,
                dropout_rate=transformer_dec_dropout_rate, init_enc_alpha=init_dec_alpha,
                **transformer,
            )
        else:
            self.decoder = ConformerEncoder(
                0, attention_dim=adim, linear_units=dunits, num_blocks=dlayers,
                dropout_rate=transformer_dec_dropout_rate,
                positional_dropout_rate=transformer_dec_positional_dropout_rate,
                attention_dropout_rate=transformer_dec_attn_dropout_rate, input_layer=None,
                normalize_before=decoder_normalize_before, concat_after=decoder_concat_after,
                cnn_module_kernel=conformer_dec_kernel_size, **conformer,
            )
        self.feat_out = Linear(adim, odim * decoder_reduction_factor, device=device)
        self.postnet = Postnet(odim, postnet_layers, postnet_chans, postnet_filts,
                               dropout_rate=postnet_dropout_rate, use_norm=use_batch_norm,
                               norm_type=postnet_norm_type, compute_dtype=cdt, device=device)

    def _encode(self, xs, ilens, spembs=None):
        xs, ilens = reduce_frames(xs, ilens, self.encoder_reduction_factor)
        hs, _ = self.encoder(xs, make_non_pad_mask(ilens, xs.shape[1]))
        if self.encoder_type == "transformer" or self.encoder_input_layer == "conv2d":
            ilens = conv2d_subsampled_lengths(ilens)
        if self.projection is not None:
            hs = integrate_spk_embed(self.projection, self.spk_embed_integration_type, hs, spembs)
        return hs, ilens

    def _dp_features(self, hs, dp_inputs):
        """Duration-predictor input: the encoder states, or a separately
        conv2d-subsampled feature nearest-resized to the encoder length."""
        if self.duration_predictor_use_encoder_outputs:
            return hs
        dp, _ = self.duration_predictor_projection(dp_inputs, None)
        return nearest_interpolate(dp, hs.shape[1])

    def _decode(self, hs_up, out_lens, mask_postnet: bool):
        """Decoder, ``feat_out`` and postnet over ``hs_up`` (B, T, adim)
        whose first ``out_lens`` frames are valid: (before, after)."""
        zs, _ = self.decoder(hs_up, make_non_pad_mask(out_lens, hs_up.shape[1]))
        before_outs = self.feat_out(zs).reshape(hs_up.shape[0], -1, self.odim)
        if not mask_postnet:  # training: the postnet reads the padded frames, as in JAX
            return before_outs, before_outs + self.postnet(before_outs)
        # zero frames past each item's length before the postnet, as the
        # reference decodes at the exact regulated length
        valid = torch.arange(before_outs.shape[1], device=hs_up.device)[None, :] < (
            out_lens * self.decoder_reduction_factor
        )[:, None]
        before_outs = torch.where(valid[..., None], before_outs, 0.0)
        return before_outs, before_outs + self.postnet(before_outs, mask=valid)

    def forward(
        self,
        src_speech: torch.Tensor,
        src_speech_lengths: torch.Tensor,
        tgt_speech: torch.Tensor,
        tgt_speech_lengths: torch.Tensor,
        durations: torch.Tensor,
        durations_lengths: Optional[torch.Tensor] = None,
        dp_inputs: Optional[torch.Tensor] = None,
        dp_lengths: Optional[torch.Tensor] = None,
        spembs: Optional[torch.Tensor] = None,
        max_feats: Optional[int] = None,
    ) -> Dict[str, torch.Tensor]:
        """Training forward on teacher durations (B, T_text), which are
        cropped or zero-padded to the encoder grid and zeroed past each
        item's length. ``durations_lengths`` and ``dp_lengths`` are accepted
        for the JAX signature and not read; ``spembs`` (B, spk_embed_dim)
        are the speaker embeddings, with ``spk_embed_dim``."""
        ys, olens = tgt_speech, tgt_speech_lengths
        hs, ilens_red = self._encode(src_speech, src_speech_lengths, spembs)
        dp_in = self._dp_features(hs, dp_inputs)
        h_nonpad = make_non_pad_mask(ilens_red, hs.shape[1])
        d_outs = self.duration_predictor(dp_in, ~h_nonpad)

        T_h = hs.shape[1]
        ds = durations[:, :T_h]
        if ds.shape[1] < T_h:
            ds = torch.nn.functional.pad(ds, (0, T_h - ds.shape[1]))
        ds = torch.where(h_nonpad, ds, 0)
        t_feats = max_feats if max_feats is not None else ys.shape[1]
        hs_up = length_regulator(hs, ds * self.teacher_model_decoder_reduction_factor, t_feats)

        r = self.decoder_reduction_factor
        before_outs, after_outs = self._decode(hs_up, olens // r if r > 1 else olens, False)
        return {
            "before_outs": before_outs,
            "after_outs": after_outs,
            "d_outs": d_outs,
            "ilens": ilens_red,
            "olens": olens - olens % r,
            "ys": ys,
        }

    @torch.no_grad()
    def inference(
        self,
        src_speech: torch.Tensor,
        src_speech_lengths: torch.Tensor,
        dp_inputs: Optional[torch.Tensor] = None,
        spembs: Optional[torch.Tensor] = None,
        alpha: float = 1.0,
        max_output_frames: Optional[int] = None,
    ) -> Dict[str, torch.Tensor]:
        """NAR inference: predict durations, regulate, decode.

        Returns outs (B, max_output_frames * r_d, odim), d_outs (B, T_text)
        the predicted durations, d_lens (B,) the valid length of their grid
        and out_lens (B,) the valid output frame counts. As in the JAX model,
        ``out_lens`` is not clamped to ``max_output_frames``.
        """
        hs, ilens_red = self._encode(src_speech, src_speech_lengths, spembs)
        dp_in = self._dp_features(hs, dp_inputs)
        h_nonpad = make_non_pad_mask(ilens_red, hs.shape[1])
        d_outs = self.duration_predictor(dp_in, ~h_nonpad, is_inference=True)
        scale = self.teacher_model_decoder_reduction_factor
        ds = torch.where(h_nonpad, torch.round(d_outs * scale * alpha), 0.0)
        if max_output_frames is None:
            max_output_frames = hs.shape[1] * scale * 4
        hs_up = length_regulator(hs, ds, max_output_frames)
        out_lens = torch.clamp(ds.sum(-1).to(torch.int32), min=1)
        _, after_outs = self._decode(hs_up, out_lens, True)
        return {
            "outs": after_outs,
            "d_outs": d_outs,
            "d_lens": ilens_red,
            "out_lens": out_lens * self.decoder_reduction_factor,
        }
