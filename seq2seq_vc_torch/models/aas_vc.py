"""AAS-VC (mirrors seq2seq_vc_tpu/models/aas_vc.py: ``setup``,
``__call__`` and ``inference``).

Conformer encoder (with post-encoder frame stacking) -> alignment module
and MAS durations (training) or the duration predictor, stochastic (run
inverse) or deterministic (inference) -> Gaussian upsampling -> the
decoder: a conformer with ``feat_out`` and the postnet, DiffSinger's
Gaussian diffusion (``decoder_type: diffsinger``, no postnet; its training
forward gives ``noise`` and ``x_recon`` for ``DiffSingerL2Loss`` and no
mel outputs) or ProDiff's x0-prediction denoiser (``prodiff``, no
``feat_out``), both conditioned on the upsampled states and float32
(``nn/diffusion.py``). ``forward`` is the training pass and also returns
the stochastic predictor's NLL of the MAS durations, or the deterministic
one's log-durations. The constructor takes the JAX model's config fields
by the same names and defaults, dropout rates included: the positionwise
layer's three kinds (``linear``, ``conv1d``, ``conv1d-linear``, of
``positionwise_conv_kernel_size`` taps), speaker embeddings
(``spk_embed_dim``, ``add`` or ``concat``; ``spembs`` to ``forward`` and
``inference``), the group- or batch-norm postnet and conv module, the
diffusion decoders' ``diffsinger_*`` and ``prodiff_*`` fields. Submodule
names are the reference torch names, so a ``state_dict`` converts with
``seq2seq_vc_tpu/convert/reference.py:convert_aasvc``; the diffusion
decoders, which the reference lacks, take the flax names.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..nn.alignment import AlignmentModule
from ..nn.attention import FLASH_MIN_LEN
from ..nn.conformer import ConformerEncoder
from ..nn.diffusion import GaussianDiffusion, SpectogramDenoiser
from ..nn.duration_predictor import DurationPredictor
from ..nn.flows import StochasticDurationPredictor
from ..nn.layers import Linear
from ..nn.pre_postnets import Postnet
from ..nn.transformer import Conv2dSubsampling
from ..ops.mas import viterbi_decode
from ..ops.masks import make_non_pad_mask
from ..ops.upsampling import gaussian_upsampling
from ..parallel.mesh import global_count
from .common import (
    conv2d_subsampled_lengths,
    integrate_spk_embed,
    nearest_interpolate,
    reduce_frames,
    speaker_projection,
)

MAX_DP_OUTPUT = 10  # duration clamp (reference ``aas_vc.py:35``)

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _conformer_types(rel_pos_type: str, pos_enc: str, self_attn: str):
    """The conformer's (pos-enc, self-attention) layer types for
    ``conformer_rel_pos_type`` (the JAX model's ``_conformer_types``):
    ``legacy`` turns the new-style ones into their legacy forms."""
    if rel_pos_type == "legacy":
        if pos_enc == "rel_pos":
            pos_enc = "legacy_rel_pos"
        if self_attn == "rel_selfattn":
            self_attn = "legacy_rel_selfattn"
    elif rel_pos_type != "latest":
        raise ValueError(f"conformer_rel_pos_type {rel_pos_type!r}")
    return pos_enc, self_attn


class AASVC(torch.nn.Module):
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
        positionwise_layer_type: str = "conv1d",
        positionwise_conv_kernel_size: int = 1,
        use_batch_norm: bool = True,
        encoder_input_layer: str = "linear",
        encoder_normalize_before: bool = False,
        decoder_normalize_before: bool = False,
        encoder_concat_after: bool = False,
        decoder_concat_after: bool = False,
        encoder_reduction_factor: int = 1,
        post_encoder_reduction_factor: int = 1,
        decoder_reduction_factor: int = 1,
        encoder_type: str = "conformer",
        decoder_type: str = "conformer",
        duration_predictor_type: str = "deterministic",
        duration_predictor_use_encoder_outputs: bool = True,
        duration_predictor_input_dim: Optional[int] = None,
        duration_predictor_layers: int = 2,
        duration_predictor_chans: int = 384,
        duration_predictor_kernel_size: int = 3,
        duration_predictor_dropout_rate: float = 0.1,
        postnet_layers: int = 5,
        postnet_chans: int = 512,
        postnet_filts: int = 5,
        postnet_dropout_rate: float = 0.5,
        diffsinger_denoiser_residual_channels: int = 256,
        diffsinger_diffusion_steps: int = 100,
        diffsinger_inference_steps: Optional[int] = None,
        prodiff_denoiser_layers: int = 20,
        prodiff_denoiser_channels: int = 256,
        prodiff_diffusion_steps: int = 1000,
        prodiff_diffusion_timescale: int = 1,
        prodiff_diffusion_beta: float = 40.0,
        prodiff_diffusion_scheduler: str = "vpsde",
        prodiff_diffusion_cycle_ln: int = 1,
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
        stochastic_duration_predictor_kernel_size: int = 3,
        stochastic_duration_predictor_dropout_rate: float = 0.5,
        stochastic_duration_predictor_flows: int = 4,
        stochastic_duration_predictor_dds_conv_layers: int = 3,
        stochastic_duration_predictor_noise_scale: float = 0.8,
        conformer_conv_norm_type: str = "group_norm",
        postnet_norm_type: str = "group_norm",
        attention_backend: str = "xla",
        flash_min_len: int = FLASH_MIN_LEN,
        rel_scores_bwd: str = "auto",
        compute_dtype: str = "float32",
        device=None,
        **unread: Any,
    ):
        """Config fields that the model does not read (loss and init
        options, ``alignment_dist_form``: the port has the ``direct`` form
        only) are accepted in ``unread`` and ignored. ``rel_scores_bwd``
        picks the fused attention's backward variant
        (``ops/rel_scores.py``)."""
        super().__init__()
        if encoder_type != "conformer":
            raise NotImplementedError("AASVC supports conformer encoder only")
        if decoder_type not in ("conformer", "diffsinger", "prodiff"):
            raise ValueError(f"decoder_type {decoder_type!r} is not supported")
        self.decoder_type = decoder_type
        if duration_predictor_type not in ("deterministic", "stochastic"):
            raise ValueError(f"unknown duration_predictor_type: {duration_predictor_type}")
        self.duration_predictor_type = duration_predictor_type
        self.idim, self.odim, self.adim = idim, odim, adim
        self.encoder_reduction_factor = encoder_reduction_factor
        self.post_encoder_reduction_factor = post_encoder_reduction_factor
        self.decoder_reduction_factor = decoder_reduction_factor
        self.encoder_input_layer = encoder_input_layer
        self.duration_predictor_use_encoder_outputs = duration_predictor_use_encoder_outputs
        self.stochastic_duration_predictor_noise_scale = stochastic_duration_predictor_noise_scale
        self.spk_embed_integration_type = spk_embed_integration_type
        cdt = _DTYPES[compute_dtype]
        pos_enc, self_attn = _conformer_types(conformer_rel_pos_type, conformer_pos_enc_layer_type,
                                              conformer_self_attn_layer_type)
        common = dict(
            positionwise_layer_type=positionwise_layer_type,
            positionwise_conv_kernel_size=positionwise_conv_kernel_size,
            macaron_style=use_macaron_style_in_conformer,
            pos_enc_layer_type=pos_enc,
            selfattention_layer_type=self_attn,
            use_cnn_module=use_cnn_in_conformer,
            conv_norm_type=conformer_conv_norm_type,
            attention_backend=attention_backend,
            flash_min_len=flash_min_len,
            rel_scores_bwd=rel_scores_bwd,
            compute_dtype=cdt,
            device=device,
        )
        self.encoder = ConformerEncoder(
            idim=idim * encoder_reduction_factor, attention_dim=adim,
            attention_heads=aheads, linear_units=eunits, num_blocks=elayers,
            dropout_rate=transformer_enc_dropout_rate,
            positional_dropout_rate=transformer_enc_positional_dropout_rate,
            attention_dropout_rate=transformer_enc_attn_dropout_rate,
            input_layer=encoder_input_layer, normalize_before=encoder_normalize_before,
            concat_after=encoder_concat_after, cnn_module_kernel=conformer_enc_kernel_size,
            **common,
        )
        self.projection = speaker_projection(spk_embed_dim, spk_embed_integration_type, adim,
                                             device)
        # the predictor's input is the stacked encoder states or the
        # separate conv2d projection of the source features
        dp_idim = (adim * post_encoder_reduction_factor
                   if duration_predictor_use_encoder_outputs else adim)
        if duration_predictor_type == "deterministic":
            self.duration_predictor = DurationPredictor(
                dp_idim, duration_predictor_layers, duration_predictor_chans,
                duration_predictor_kernel_size, duration_predictor_dropout_rate, device=device,
            )
        else:  # works at adim
            self.duration_predictor = StochasticDurationPredictor(
                in_channels=dp_idim,
                channels=adim,
                kernel_size=stochastic_duration_predictor_kernel_size,
                flows=stochastic_duration_predictor_flows,
                dds_conv_layers=stochastic_duration_predictor_dds_conv_layers,
                dropout_rate=stochastic_duration_predictor_dropout_rate,
                device=device,
            )
        if not duration_predictor_use_encoder_outputs:
            self.duration_predictor_projection = Conv2dSubsampling(
                duration_predictor_input_dim or idim, adim, device=device,
            )
        self.alignment_module = AlignmentModule(
            adim * post_encoder_reduction_factor, odim * decoder_reduction_factor,
            device=device,
        )
        cond_dim, out_dim = adim * post_encoder_reduction_factor, odim * decoder_reduction_factor
        self.feat_out = None
        if decoder_type == "diffsinger":
            self.decoder = GaussianDiffusion(
                cond_dim, out_dim, residual_channels=diffsinger_denoiser_residual_channels,
                timesteps=diffsinger_diffusion_steps,
                inference_steps=diffsinger_inference_steps, device=device,
            )
        elif decoder_type == "prodiff":
            self.decoder = SpectogramDenoiser(
                out_dim, cond_dim, layers=prodiff_denoiser_layers,
                channels=prodiff_denoiser_channels, timesteps=prodiff_diffusion_steps,
                timescale=prodiff_diffusion_timescale, max_beta=prodiff_diffusion_beta,
                scheduler=prodiff_diffusion_scheduler, cycle_length=prodiff_diffusion_cycle_ln,
                device=device,
            )
        else:
            self.decoder = ConformerEncoder(
                idim=0, attention_dim=cond_dim,
                attention_heads=aheads, linear_units=dunits, num_blocks=dlayers,
                dropout_rate=transformer_dec_dropout_rate,
                positional_dropout_rate=transformer_dec_positional_dropout_rate,
                attention_dropout_rate=transformer_dec_attn_dropout_rate,
                input_layer=None, normalize_before=decoder_normalize_before,
                concat_after=decoder_concat_after, cnn_module_kernel=conformer_dec_kernel_size,
                **common,
            )
            self.feat_out = Linear(cond_dim, out_dim, device=device)
        # "only diffsinger does not have postnet" (the reference's words)
        self.postnet = (
            Postnet(odim, postnet_layers, postnet_chans, postnet_filts,
                    dropout_rate=postnet_dropout_rate, use_norm=use_batch_norm,
                    norm_type=postnet_norm_type, compute_dtype=cdt, device=device)
            if postnet_layers > 0 and decoder_type != "diffsinger" else None
        )

    def text_frames(self, n_frames):
        """The length of the encoder's (the duration predictor's) grid for
        ``n_frames`` source frames (an int or an integer array): the
        stacking, a ``conv2d`` input layer's subsampling and the post-encoder
        stacking."""
        t = n_frames // self.encoder_reduction_factor
        if self.encoder_input_layer == "conv2d":
            t = conv2d_subsampled_lengths(t)
        return t // self.post_encoder_reduction_factor

    def _encode(self, xs, ilens, spembs=None):
        xs, ilens = reduce_frames(xs, ilens, self.encoder_reduction_factor)
        hs, _ = self.encoder(xs, make_non_pad_mask(ilens, xs.shape[1]))
        if self.encoder_input_layer == "conv2d":
            ilens = conv2d_subsampled_lengths(ilens)
        if self.projection is not None:
            hs = integrate_spk_embed(self.projection, self.spk_embed_integration_type, hs, spembs)
        return reduce_frames(hs, ilens, self.post_encoder_reduction_factor)

    def _dp_features(self, hs, dp_inputs):
        """Duration-predictor conditioner: encoder states, or a separately
        conv2d-subsampled feature nearest-resized to the encoder length."""
        if self.duration_predictor_use_encoder_outputs:
            return hs
        dp, _ = self.duration_predictor_projection(dp_inputs, None)
        return nearest_interpolate(dp, hs.shape[1])

    def forward(
        self,
        src_speech: torch.Tensor,
        src_speech_lengths: torch.Tensor,
        tgt_speech: torch.Tensor,
        tgt_speech_lengths: torch.Tensor,
        dp_inputs: Optional[torch.Tensor] = None,
        dp_lengths: Optional[torch.Tensor] = None,
        spembs: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        diffusion_draws: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, Optional[torch.Tensor]]:
        """Training forward (``__call__`` of the JAX model).

        MAS durations ``ds`` (no gradient) from the alignment log-probs
        drive the Gaussian upsampling; ``bin_loss`` and ``log_p_attn`` keep
        their gradient. The stochastic predictor gives ``dur_nll``, its NLL
        of ``ds`` summed over tokens and divided by the valid-token count;
        ``noise`` (B, T_text, 2) is its e_q draw (else drawn from
        ``generator``). The deterministic one gives ``d_outs``, its
        log-durations clamped at ``MAX_DP_OUTPUT``.
        ``dp_lengths`` is accepted for the JAX signature and not read.
        ``spembs`` (B, spk_embed_dim): the speaker embeddings, with
        ``spk_embed_dim``. A diffusion decoder draws its step and noise
        from ``generator`` after the duration predictor, or takes them from
        ``diffusion_draws`` (``t``, ``eps``); ``diffsinger`` returns
        ``noise`` and ``x_recon`` and no mel outputs (``before_outs`` and
        ``after_outs`` None).
        """
        xs, ys = src_speech, tgt_speech
        ilens, olens = src_speech_lengths, tgt_speech_lengths
        hs, ilens_red = self._encode(xs, ilens, spembs)
        dp_in = self._dp_features(hs, dp_inputs)
        ys_red, olens_red = reduce_frames(ys, olens, self.decoder_reduction_factor)

        h_nonpad = make_non_pad_mask(ilens_red, hs.shape[1])
        log_p_attn = self.alignment_module(hs, ys_red, ~h_nonpad)
        ds, bin_loss = viterbi_decode(log_p_attn, ilens_red, olens_red)

        if self.duration_predictor_type == "deterministic":
            d_outs = self.duration_predictor(dp_in, ~h_nonpad)
            dur = {"d_outs": torch.clamp(d_outs, max=MAX_DP_OUTPUT)}
        else:
            dur_nll = self.duration_predictor.nll(dp_in, h_nonpad, ds, noise, generator)
            dur = {"dur_nll": dur_nll.sum() / torch.clamp(global_count(h_nonpad.sum()), min=1)}

        hs_up = gaussian_upsampling(
            hs, ds, make_non_pad_mask(olens_red, ys_red.shape[1]), h_nonpad
        )
        d_masks = make_non_pad_mask(olens_red, hs_up.shape[1])
        B = hs_up.shape[0]
        draws = dict(diffusion_draws or {}, generator=generator)
        diffusion: Dict[str, torch.Tensor] = {}
        if self.decoder_type == "diffsinger":
            diffusion["noise"], diffusion["x_recon"] = self.decoder(hs_up, ys_red, d_masks,
                                                                    **draws)
            before_outs = after_outs = None
        else:
            if self.decoder_type == "prodiff":  # no feat_out
                before_outs = self.decoder(hs_up, ys_red, d_masks, **draws).reshape(
                    B, -1, self.odim)
            else:
                zs, _ = self.decoder(hs_up, d_masks)
                before_outs = self.feat_out(zs).reshape(B, -1, self.odim)
            after_outs = before_outs
            if self.postnet is not None:
                after_outs = before_outs + self.postnet(before_outs)
        return {
            "before_outs": before_outs,
            "after_outs": after_outs,
            **dur,
            **diffusion,
            "ds": ds,
            "ilens": ilens_red,
            "bin_loss": bin_loss,
            "log_p_attn": log_p_attn,
            "olens_reduced": olens_red,
            "olens": olens - olens % self.decoder_reduction_factor,
            "ys": ys,
        }

    @torch.no_grad()
    def inference(
        self,
        src_speech: torch.Tensor,
        src_speech_lengths: torch.Tensor,
        dp_inputs: Optional[torch.Tensor] = None,
        spembs: Optional[torch.Tensor] = None,
        max_output_frames: Optional[int] = None,
        tgt_speech: Optional[torch.Tensor] = None,
        tgt_speech_lengths: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        diffusion_draws: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        """NAR inference: predict durations, upsample, decode.

        Returns outs (B, T_out_max * r_d, odim), d_outs (B, T_text), d_lens
        and out_lens (B,) valid output frame counts. ``noise`` (B, T_text,
        2) is the stochastic duration predictor's standard-normal draw (else
        drawn from ``generator``). With a ground-truth target (debug use),
        the MAS durations ``ds`` and ``log_p_attn`` are returned as well.
        A diffusion decoder samples with ``generator`` (after the duration
        predictor's draw) or takes its draws from ``diffusion_draws``
        (``x_init``, ``z``).
        """
        hs, ilens_red = self._encode(src_speech, src_speech_lengths, spembs)
        debug: Dict[str, torch.Tensor] = {}
        if tgt_speech is not None:
            ys_red, olens_red = reduce_frames(
                tgt_speech, tgt_speech_lengths, self.decoder_reduction_factor
            )
            x_pad_mask = ~make_non_pad_mask(ilens_red, hs.shape[1])
            log_p_attn = self.alignment_module(hs, ys_red, x_pad_mask)
            ds_gt, _ = viterbi_decode(log_p_attn, ilens_red, olens_red)
            debug = {"ds": ds_gt, "log_p_attn": log_p_attn, "ilens": ilens_red}
        dp_in = self._dp_features(hs, dp_inputs)
        h_nonpad = make_non_pad_mask(ilens_red, hs.shape[1])

        if self.duration_predictor_type == "deterministic":
            d_outs = self.duration_predictor(dp_in, ~h_nonpad, is_inference=True)
        else:
            d_outs = self.duration_predictor(
                dp_in, h_nonpad, noise_scale=self.stochastic_duration_predictor_noise_scale,
                noise=noise, generator=generator,
            )
        d_outs = torch.clamp(d_outs, max=MAX_DP_OUTPUT)
        d_outs = torch.where(h_nonpad, d_outs, 0.0)

        if max_output_frames is None:
            max_output_frames = hs.shape[1] * MAX_DP_OUTPUT
        out_lens_red = torch.clamp(
            d_outs.sum(-1).to(torch.int32), min=1, max=max_output_frames
        )
        h_masks = make_non_pad_mask(out_lens_red, max_output_frames)
        hs_up = gaussian_upsampling(hs, d_outs, h_masks, h_nonpad)
        B = hs_up.shape[0]
        draws = dict(diffusion_draws or {}, generator=generator)
        if self.feat_out is None:  # a diffusion decoder (diffsinger has no postnet)
            x = self.decoder.inference(hs_up, h_masks, **draws)
            before_outs = after_outs = x.reshape(B, -1, self.odim)
        else:
            zs, _ = self.decoder(hs_up, h_masks)
            before_outs = after_outs = self.feat_out(zs).reshape(B, -1, self.odim)
        if self.postnet is not None:
            # zero frames past each item's predicted length before the
            # postnet, as the reference decodes at the exact length
            valid = torch.arange(before_outs.shape[1], device=hs.device)[None, :] < (
                out_lens_red * self.decoder_reduction_factor
            )[:, None]
            before_outs = torch.where(valid[..., None], before_outs, 0.0)
            after_outs = before_outs + self.postnet(before_outs, mask=valid)
        return {
            "outs": after_outs,
            "d_outs": d_outs,
            "d_lens": ilens_red,  # valid length of the duration grid
            "out_lens": out_lens_red * self.decoder_reduction_factor,
            **debug,
        }
