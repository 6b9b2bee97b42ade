#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``seq2seq_vc_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # from the repository root; needs one card
    python3 chip_smoke.py --bwd-sweep  # only: the rel-scores backward's three
                                       # variants timed over T (the bwd="auto" gate)
    python3 chip_smoke.py --flash-sweep  # only: one attention layer's forward +
                                         # backward, fused (rel-pos) or dense
                                         # (standard) route vs flash route, ms and
                                         # memory over T (the flash gate)

Phases, each printed on lines of its own:

1. the card (``nvidia-smi`` name and power limit), the TF32 switches (both
   off), which of ``yaml``, ``h5py``, ``matplotlib`` and ``tqdm`` import,
   and the build of every CUDA kernel from ``seq2seq_vc_torch/csrc``
   (one ``nvcc`` per source, started together), with each kernel's
   registers and spills (no variant of kernels 1, 3-5 and 9-11 may
   spill), and the HMMA instructions of every variant of the tensor-core
   kernels (1-11) in ``cuobjdump -sass``: each bfloat16 variant
   must issue them, no float32 one may;
2. warm-up: a full-width ``Wav2WavConverter`` (the AAS-VC flagship of
   ``egs/arctic/vc2/conf/aas_vc.melmelmel.v1.yaml`` and the HiFi-GAN that
   ``bench.py`` serves) with seeded random weights serves a 3.8 s clip, a
   batch of 4 and a 30 s clip whose decoder key length crosses the flash
   gate, then runs its synthesis ladder once;
3. each kernel against its plain PyTorch version on the same inputs, in
   float32 and bfloat16 at the flagship's two head dims (encoder D 192 at
   T 640, decoder D 768 at T 1300), and in bfloat16 at every shape and key
   length that the main path gave it in phase 2: max abs error against the
   stated tolerance, the kernel's time, the plain version's, the library
   yardstick's and the bound (bytes over 3.35 TB/s or operations over the
   type's peak); for kernel 1 also ``half_work_ms``, q_u.k^T alone in
   cuBLAS (half its products; no single PyTorch call computes all of it);
4. the main path: the same requests again, timed. The kernels' launch
   counts are set to 0 just before and read just after; each must equal
   what the routing predicts, and be above 0;
5. a reference check: the same weights in float32 convert one short clip on
   the card (through both kernels) and on the CPU (through their plain
   versions), and the waveforms must agree;
6. a profile of the 30 s request: device time by kernel (torch.profiler)
   and the device's busy share of the request's untraced latency;
7. training warm-up: an ``AASVCTrainer`` on the full-width flagship (bf16,
   dropout 0.2, the YAML's Adam, warmuplr and clipping) takes one step on a
   synthetic parallel corpus of ``.npy`` features written from a seed and
   read back through the port's dataset, collater and loader (B 16); then
   the backward kernel against its plain version in float32 and bfloat16 at
   both head dims, and both rel-scores kernels at every shape the training
   steps give them, with the ``bwd="xla"`` variant's time as the backward's
   yardstick;
8. the training path: 3 steps at target lengths 160-512 frames (T 512) and
   2 at 480-960 (T 960), with the launch counts set to 0 just before and read
   just after (each must equal what the routing predicts: the fused kernels
   above 0, the flash kernels 0 below the gate),
   ms/step, peak memory, a finite loss, and before each update every
   gradient finite and every attention projection's gradient non-zero; the
   MAS loop timed alone; a profile of one step at each length (busy share,
   top kernels);
9. a reference training step: the same float32 weights and batch, dropout
   off, on the card (through both rel-scores kernels) and on the CPU
   (through their plain versions); loss and gradients must agree;
10. long-utterance training: a fresh full-width flagship takes one warm-up
   step on a B 16 batch whose sources and targets spread over
   FLASH_MIN_LEN..FLASH_MIN_LEN+256 frames (2048-2304: 33-37 s of audio),
   so that every conformer layer takes the flash route with dropout 0.2;
   then the flash forward (with dropout and logsumexp) and its three
   backward kernels against their plain versions in float32 and bfloat16 at
   both head dims, rate 0 and 0.2, with key-length padding and a fully
   masked batch row, and in bfloat16 at every shape the long steps give
   them (the backward's yardstick: SDPA's forward + backward with the band
   as a bias, beside the four kernels' forward + backward); then 3 timed
   steps with the launch counts set to 0 just before and read just after
   (8 of each flash kernel per step, no fused launch), ms/step, peak
   memory, a finite loss, every gradient finite and every attention
   projection's gradient non-zero before each update, and a profile of one
   step;
11. a reference training step through the flash route: as phase 9 with the
   flash gate lowered below the batch's lengths (kernels 2, 6, 7 and 8 on
   the card, their plain versions on the CPU);
12. VTN serving: a full-width ``Wav2WavARConverter`` (the VTN of
   ``egs/arctic/vc1/conf/vtn.v1.yaml``, float32, ``attention_backend:
   flash``, seeded random weights, and phase 2's HiFi-GAN) decodes with
   threshold 1.1 and maxlenratio 4.0, as bench.py times the AR decode, so
   that every decode runs its whole budget; requests: a 3.8 s clip, a batch
   of 4 and a 135 s clip, whose encoder key length (~2100 after the x4
   subsampling) crosses the flash gate. Warm-up (the 135 s clip at a
   quarter of its step budget: the same kernels and shapes), then the
   standard flash
   forward (kernel 9) against its plain version (float32 and bfloat16, D 96
   at T 640, at the long request's length and at a cross shape, rate 0 and
   0.2, causal off and on, key padding and a fully masked row; and at the
   main path's shape), then the timed requests with the launch counts set to
   0 just before and read just after (6 launches of kernel 9 for the long
   request, none for the short ones or for kernels 10-11), latency, RTF and
   AR steps per second, peak memory, and a profile of the long request;
13. a VTN reference check: the same weights in float32 with the prenet's
   dropout 0 and the flash gate below a 1 s clip's encoder length convert
   the clip on the card (kernel 9) and on the CPU (its plain version); the
   decoded features and the waveforms must agree;
14. VTN training at the common length: an ``ARVCTrainer`` on the
   full-width VTN in bf16 with the YAML's dropouts (0.1, prenet 0.5), Adam
   lr 8e-5, warmuplr 4000, clipping 1.0 and bce_pos_weight 10 takes 3 steps
   at B 16 on sources and targets of 160-512 frames read through the port's
   dataset, collater and loader (no flash launch expected): ms/step, peak
   memory, finite loss, finite and non-zero attention gradients;
15. VTN long training: B 16 with sources and targets of 8200-9200 frames,
   so that every encoder layer's key length lies in FLASH_MIN_LEN ..
   FLASH_MIN_LEN + 256 after the subsampling; kernels 9-11 against their
   plain versions at the steps' shape (SDPA forward + backward with the
   key-padding mask as the yardstick, and for 10-11 SDPA's backward alone
   too), 9, 10 and 11 also at rate 0 (the dropout hash's cost), the pair 10 +
   11 beside SDPA's backward alone; 3 timed steps with 6 launches of each
   of kernels 9, 10 and 11 per step, ms/step, peak memory, finite loss and
   gradients, and a profile of one step;
16. a VTN reference training step through the flash route: float32,
   dropout off, the gate lowered; the loss and every gradient on the card
   and on the CPU must agree to phase 9's tolerances;
17. legacy serving: the flagship with ``conformer_rel_pos_type: legacy``
   (seeded random weights) serves phase 2's three requests. The legacy
   attention never takes the fused kernel, so below the flash gate it runs
   the dense ops and kernel 2's legacy form (q_v and the (H, T, D) table D
   wide, each band cell reading q_v row i or i+1 by the sign of j - i)
   launches exactly in the 30 s request's decoder; that kernel against its
   plain version at both head dims (float32 and bfloat16) and at the main
   path's shape, then the timed requests with
   the launch counts set to 0 just before and read just after;
18. a legacy reference check: phase 5 on the legacy flagship (the legacy
   kernel 2 on the card, its plain version on the CPU);
19. legacy long training: phase 10 on a fresh legacy flagship, every layer
   on the legacy form of kernels 2, 6, 7 and 8 (their checks at both head
   dims, float32 and bfloat16, rate 0 and 0.2, and at the steps' shapes,
   against SDPA with the dense legacy band as a bias), one warm-up step and
   2 timed steps (8 launches of each a step), and a profile of one step;
20. a legacy reference training step: phase 11 in the legacy form;
21. the fused route's ``pallas`` backward: a flagship with ``rel_scores_bwd:
   pallas`` takes one warm-up step and 2 timed steps at B 16 on 480-960
   frames (8 launches of each of kernels 4 and 5 a step, none of kernel 3);
   kernels 4 and 5 against their plain versions at T 512 and 960, D 192 and
   768, float32 and bfloat16, and at the steps' shapes (the ``xla``
   variant's time as their yardstick);
22. the CLIs, driven in-process through their ``main(argv)`` on a corpus
   the phase builds with the port's own wav, log-mel and stats modules
   (``.npy`` features, ``feats.scp``, ``.npz`` stats): ``vc_train`` on the
   shipped flagship conf at full width (B 16) for 3 steps, evaluating (with
   ``generate_intermediate``) and saving at step 2, then ``--resume`` to
   step 4 (kernels 1 and 3 must launch); ``vc_decode`` of the dev set
   through a seeded HiFi-GAN the phase saved (batch size 1, again, on
   lengths and buckets it has not met, on new lengths in buckets it has,
   and batch size 4: ms an utterance and mel-frames/s), one utterance's features held against
   ``AASVC.inference`` on the same weights and generator; ``vc_serve`` over
   stdio with three requests, the last long enough that the encoder's keys
   reach the flash gate (kernels 1 and 2 must launch; wall ms and RTF of
   each); ``vc_train`` (2 steps) and ``vc_decode`` (2 utterances,
   Griffin-Lim) on the VTN's shipped conf; each kernel checked at the
   shapes the CLIs gave it;
23. FastSpeech-VC (``egs/arctic/vc2/conf/fs2_vc.melmelmel.v1.yaml`` at
   full width, bf16, seeded random weights): a ``Wav2WavConverter`` with
   phase 2's HiFi-GAN serves phase 2's three requests (the 30 s request's
   decoder, at twice the padded source frames, past the flash gate),
   printing each request's latency, RTF and predicted output frames, with
   the launch counts of kernels 1 and 2 held to the routing, and a float32
   conversion card against CPU; a ``NARVCTrainer`` at B 16 on a corpus with
   teacher durations (``<utt>.txt``, one integer per encoder frame summing
   to the target length), dropout 0.2: 3 steps at 160-512 target frames
   (kernels 1 and 3) and 2 at 2048-2304 (the decoder on kernels 2 and 6-8
   at D 192, the encoder's 511-575 frames on 1 and 3), ms a step, peak
   memory, busy share, finite loss and gradients, launches as the routing
   predicts, and a float32 step card against CPU with the decoder on the
   flash route; ``vc_train`` with ``--train-duration-dir`` (3 steps, then
   ``--resume`` to 4), ``vc_decode`` of the dev set (its features and
   durations held against ``FastSpeechVC.inference``) and ``vc_serve``
   over stdio, its last request long enough for the decoder's flash gate;
   every kernel checked at every shape the phase gave it (``check ...
   fs2`` rows);
24. Transformer-TTS and the VTN's TTS pretraining
   (``egs/ljspeech/tts1/run.sh`` stages 1, 3, 4 and 6, then
   ``egs/arctic/vc1/conf/vtn.tts_pt.v1.yaml``), through the CLIs on a
   synthetic corpus of 16 train and 4 dev sentences (40-180 characters,
   150-600 ``.npy`` mel frames) tokenised by ``tokenize_text`` (``phn``,
   the native English G2P): (a) ``tts_train`` at the full width of
   ``transformer_tts.v1.yaml`` (float32, B 16, guided attention on 2
   layers x 2 heads) for 3 steps: ms a step, peak memory, a finite loss,
   the guided term finite and above 0, every gradient finite before each
   update; (b) ``tts_decode`` of three short sentences through
   Griffin-Lim: frames and ms an utterance (untrained weights run the
   ``maxlenratio`` budget); (c) the AEPT stage, ``vc_train`` with the TTS
   conf, ``tts_aept.v1.yaml`` (steps cut to 3) and the TTS checkpoint:
   each ``init-mods`` module equal to the TTS checkpoint's bit for bit
   after steps 1 and 3 (transferred, then frozen), the prenet and the
   encoder moving, the guided term in the loss; (f) the fine-tune
   overlay from the AEPT checkpoint (2 steps, its ``init-mods``
   transferred, nothing frozen); (d) one AEPT step at 8200-9200 frames
   with ``attention_backend: flash`` at the largest batch whose reckoned
   memory fits (``aept_long_batch``): 6 launches of each of kernels 9, 10
   and 11, which are then held against their plain versions at the step's
   shape (float32, ``check ... tts`` rows); (e) a float32 AEPT step card
   against CPU (freeze-mods, guided attention, dense): loss, terms and
   every trainable gradient;
25. the recipes' vocoders, written with seeded weights as
   ``parallel_wavegan`` checkpoints (weight-normed) and an s3prl-vc
   Taco2-AR checkpoint: ParallelWaveGAN at ``parallel_wavegan.v1``'s
   widths, MelGAN at ``melgan.v1``'s, StyleMelGAN and Taco2-AR (over
   144-wide PPG, a PWG as its inner vocoder) at the JAX classes'
   defaults: (a) ``vc_decode`` of the AAS-VC flagship with a PWG
   ``vocoder:`` block over a 3.8 s and a 30 s utterance (kernels 1 and 2
   launch and are checked at the decode's shapes, ``check ... voc``
   rows); (b) ``vc_decode`` of the full-width VTN of
   ``egs/arctic/vc1/conf/vtn.v1.melppg.yaml`` (``--feat-type
   ppg_sxliu``) through the s3prl-vc vocoder, its budget cut as phase
   12's; (c) ``vocoder_anasyn_debug`` with MelGAN and with StyleMelGAN;
   then each vocoder's time, RTF and peak memory at 3.8 and 30 s,
   Taco2-AR's ms and device activities a step, bf16 against float32 on
   the card and float32 card against CPU (``VOC_*_RTOL``);
26. feature extraction, the recipe's stages 1-4 on the card
   (``feature_path``): a corpus of 22.05 kHz wavs (per speaker 16 train
   and 4 dev clips of 2.0-5.0 s; the source's dev clips with near-silent
   edges under ``trim_silence``; an 8 s recording cut by a kaldi
   ``segments`` file and a 30 s clip) through ``preprocess`` with an
   overlay of ``egs/arctic/vc2/conf/aas_vc.ppgmelppg.v1.yaml`` (``format:
   npy``; ``mel``, ``ppg_sxliu`` from a seeded espnet-named upstream at
   adim 144, 4 heads, 576 units, 12 blocks and an s3prl-vc-style
   featurizer, and ``encodec`` from a seeded HF-named EnCodec state dict),
   ``compute_statistics`` and ``normalize``; ``vc_train`` of that conf at
   full width (B 16, 3 steps: kernels 1 and 3, launches as the routing
   predicts, each checked at the step's shapes, ``check ... feat`` rows)
   and ``vc_decode`` of the dev set, the segments and the 30 s clip
   (kernel 1, the same); ``get_vocoder``'s ``encodec`` block over the 3.8
   and 30 s latents. Frame counts as JAX computes them, every array
   finite, the statistics against float64 numpy, ``normalize`` against
   its formula, float32 card against CPU for the log-mel, the PPG, the
   EnCodec embeddings and waveform (``FEAT_*``); ms and RTF of each at 3.8
   and 30 s, the PPG frames a second, peak memory.

Then the script's time, the ``kernels`` JSON line (every kernel, the legacy
form of kernels 2 and 6-8 as rows of their own, each with its launches by
path, phase 23's ``fs2_*``, phase 24's ``tts_*``, phase 25's ``voc_*`` and
phase 26's ``feat_*`` paths included;
kernels 10-11 with SDPA's backward alone as ``library_bwd_ms``, kernels
9-11 with their rate-0 time as ``ms_rate_0``, kernel 1 with
``half_work_ms``, q_u.k^T alone in cuBLAS, a reference and not its library
column), the card line again, and last the result line. Any failed check
makes the script exit with 1 without the result line; with no CUDA device
it exits at once.
"""

from __future__ import annotations

import copy
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}  # fp32: CUDA cores

# model_params of egs/arctic/vc2/conf/aas_vc.melmelmel.v1.yaml (keys that
# only training reads are accepted and ignored by AASVC)
FLAGSHIP = dict(
    idim=80, odim=80, adim=384, aheads=2, elayers=4, eunits=1536, dlayers=4,
    dunits=1536, positionwise_layer_type="linear", positionwise_conv_kernel_size=1,
    duration_predictor_use_encoder_outputs=False, duration_predictor_input_dim=80,
    duration_predictor_layers=2, duration_predictor_chans=256,
    duration_predictor_kernel_size=3, postnet_layers=5, postnet_filts=5,
    postnet_chans=256, use_masking=True, encoder_normalize_before=True,
    decoder_normalize_before=True, encoder_reduction_factor=1,
    post_encoder_reduction_factor=4, decoder_reduction_factor=1,
    encoder_type="conformer", decoder_type="conformer",
    duration_predictor_type="stochastic", encoder_input_layer="linear",
    conformer_pos_enc_layer_type="rel_pos", conformer_self_attn_layer_type="rel_selfattn",
    use_macaron_style_in_conformer=True, use_cnn_in_conformer=True,
    conformer_enc_kernel_size=15, conformer_dec_kernel_size=15,
    init_type="xavier_uniform", attention_backend="flash", compute_dtype="bfloat16",
    transformer_enc_dropout_rate=0.2, transformer_enc_positional_dropout_rate=0.2,
    transformer_enc_attn_dropout_rate=0.2, transformer_dec_dropout_rate=0.2,
    transformer_dec_positional_dropout_rate=0.2, transformer_dec_attn_dropout_rate=0.2,
)
# model_params of egs/arctic/vc2/conf/fs2_vc.melmelmel.v1.yaml (phase 23), in
# bf16 as the flagship runs; the duration predictor's and the postnet's
# dropouts at the model's defaults (0.1, 0.5), which the YAML leaves
FS2_CONF = REPO / "egs/arctic/vc2/conf/fs2_vc.melmelmel.v1.yaml"
FS2 = dict(
    idim=80, odim=80, adim=384, aheads=2, elayers=4, eunits=1536, dlayers=4, dunits=1536,
    positionwise_layer_type="linear", positionwise_conv_kernel_size=1,
    duration_predictor_use_encoder_outputs=False, duration_predictor_input_dim=80,
    duration_predictor_layers=2, duration_predictor_chans=256,
    duration_predictor_kernel_size=3, postnet_layers=5, postnet_filts=5, postnet_chans=256,
    use_masking=True, encoder_normalize_before=True, decoder_normalize_before=True,
    encoder_reduction_factor=1, decoder_reduction_factor=1, encoder_type="conformer",
    decoder_type="conformer", encoder_input_layer="conv2d",
    conformer_pos_enc_layer_type="rel_pos", conformer_self_attn_layer_type="rel_selfattn",
    use_macaron_style_in_conformer=True, use_cnn_in_conformer=True,
    conformer_enc_kernel_size=15, conformer_dec_kernel_size=15, init_type="xavier_uniform",
    attention_backend="flash", compute_dtype="bfloat16",
    transformer_enc_dropout_rate=0.2, transformer_enc_positional_dropout_rate=0.2,
    transformer_enc_attn_dropout_rate=0.2, transformer_dec_dropout_rate=0.2,
    transformer_dec_positional_dropout_rate=0.2, transformer_dec_attn_dropout_rate=0.2,
    teacher_model_decoder_reduction_factor=1,
)
FS2_CRITERIONS = ("L1Loss", "DurationPredictorLoss")
FS2_NO_DROPOUT = dict({k: 0.0 for k in FS2 if k.endswith("dropout_rate")},
                      duration_predictor_dropout_rate=0.0, postnet_dropout_rate=0.0)
# the modules whose outputs feed a ReLU: the conv2d subsamplings' convs and
# the duration predictor's convs (the conformer's feed-forwards use swish);
# phase 23's reference step holds a module's own gradients to FLIP_RTOL
# where one of its outputs lies on the other side of 0 on the other device
FS2_RELU_INPUTS = ("embed.conv.0", "embed.conv.2", "projection.conv.0", "projection.conv.2",
                   "duration_predictor.conv.0.0", "duration_predictor.conv.1.0")
# the feature settings of the same file
FEATS = {"sampling_rate": 16000, "fft_size": 1024, "hop_size": 256, "win_length": None,
         "num_mels": 80, "fmin": 80, "fmax": 7600}
# bench.py's serving vocoder: HiFi-GAN V1 widths with hop 256
HIFIGAN = dict(in_channels=80, upsample_channels=512, upsample_factors=(8, 8, 2, 2),
               upsample_kernel_sizes=(16, 16, 4, 4), resblock_kernel_sizes=(3, 7, 11),
               resblock_dilation_sizes=((1, 3, 5),) * 3)

KERNELS = {
    "fused_rel_scores": dict(
        route="cuda", source="seq2seq_vc_torch/csrc/rel_scores.cu",
        replaces="seq2seq_vc_tpu/ops/rel_scores.py:95",
    ),
    "rel_band_bwd": dict(
        route="cuda", source="seq2seq_vc_torch/csrc/rel_scores_bwd.cu",
        replaces="seq2seq_vc_tpu/ops/rel_scores.py:170",
    ),
    "rel_flash_attention": dict(
        route="cuda", source="seq2seq_vc_torch/csrc/rel_flash.cu",
        replaces="seq2seq_vc_tpu/ops/flash_attention.py:578",
    ),
    "rel_flash_bwd_dq": dict(
        route="cuda", source="seq2seq_vc_torch/csrc/rel_flash_bwd_dq.cu",
        replaces="seq2seq_vc_tpu/ops/flash_attention.py:654",
    ),
    "rel_flash_bwd_dkv": dict(
        route="cuda", source="seq2seq_vc_torch/csrc/rel_flash_bwd_dkv.cu",
        replaces="seq2seq_vc_tpu/ops/flash_attention.py:695",
    ),
    "rel_flash_bwd_dpos": dict(
        route="cuda", source="seq2seq_vc_torch/csrc/rel_flash_bwd_dpos.cu",
        replaces="seq2seq_vc_tpu/ops/flash_attention.py:732",
    ),
}
KERNELS.update({
    "flash_attention": dict(
        route="cuda", source="seq2seq_vc_torch/csrc/flash.cu",
        replaces="seq2seq_vc_tpu/ops/flash_attention.py:111",
    ),
    "flash_bwd_dq": dict(
        route="cuda", source="seq2seq_vc_torch/csrc/flash_bwd.cu",
        replaces="seq2seq_vc_tpu/ops/flash_attention.py:229",
    ),
    "flash_bwd_dkv": dict(
        route="cuda", source="seq2seq_vc_torch/csrc/flash_bwd.cu",
        replaces="seq2seq_vc_tpu/ops/flash_attention.py:260",
    ),
})
FLASH_BWD = ("rel_flash_bwd_dq", "rel_flash_bwd_dkv", "rel_flash_bwd_dpos")
STD = ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv")  # the standard flash kernels
PAIR = ("rel_band_bwd_dqv", "rel_band_bwd_dpos")  # kernels 4 and 5: bwd="pallas"
KERNELS.update({
    "rel_band_bwd_dqv": dict(
        route="cuda", source="seq2seq_vc_torch/csrc/rel_scores_bwd_pair.cu",
        replaces="seq2seq_vc_tpu/ops/rel_scores.py:103",
    ),
    "rel_band_bwd_dpos": dict(
        route="cuda", source="seq2seq_vc_torch/csrc/rel_scores_bwd_pair.cu",
        replaces="seq2seq_vc_tpu/ops/rel_scores.py:122",
    ),
})
# the legacy form of kernels 2 and 6-8 (D wide, on q_v and the (H, T, D)
# table as the module holds them), rows of their own: same sources, same
# TPU kernels, own launch counts
LEGACY_TAG = "[legacy]"
LEGACY = tuple(n + LEGACY_TAG for n in ("rel_flash_attention", *FLASH_BWD))
KERNELS.update({n: dict(KERNELS[n.removesuffix(LEGACY_TAG)]) for n in LEGACY})
# what each kernel's library_ms times (a yardstick the port never calls)
LIBRARY = {"fused_rel_scores": "no single PyTorch call",
           **{n: "the bwd='xla' variant in torch ops" for n in ("rel_band_bwd", *PAIR)},
           "rel_flash_attention": "SDPA with the band materialised as a bias",
           **{n: "SDPA forward + backward with the band materialised as a bias" for n in FLASH_BWD},
           "rel_flash_attention[legacy]": "SDPA with the dense legacy band as a bias",
           **{n: "SDPA forward + backward with the dense legacy band as a bias"
              for n in LEGACY[1:]},
           "flash_attention": "SDPA with the key-padding mask",
           "flash_bwd_dq": "SDPA forward + backward with the key-padding mask "
                           "(library_bwd_ms: SDPA backward alone)",
           "flash_bwd_dkv": "SDPA forward + backward with the key-padding mask "
                            "(library_bwd_ms: SDPA backward alone)"}
# the kernels each main path runs (serving runs no backward; training at
# key lengths from the flash gate runs only the flash kernels; the legacy
# form never takes the fused kernel, so its serving and its training under
# the gate run the dense ops)
PATH_KERNELS = {"serve": ("fused_rel_scores", "rel_flash_attention"),
                "train": ("fused_rel_scores", "rel_band_bwd"),
                "train_long": ("rel_flash_attention", *FLASH_BWD),
                "vtn_serve": ("flash_attention",),
                "vtn_train": (),  # key lengths under the gate: the dense route only
                "vtn_train_long": STD,
                "legacy_serve": LEGACY[:1],
                "train_long_legacy": LEGACY,
                "train_pallas": ("fused_rel_scores", *PAIR),
                # phase 22, the CLIs: vc_train and vc_decode of the dev set
                # under the gate, vc_serve with a request past it; the VTN's
                # conf leaves its attention backend at xla (dense)
                "cli_train": ("fused_rel_scores", "rel_band_bwd"),
                "cli_decode": ("fused_rel_scores",),
                "cli_serve": ("fused_rel_scores", "rel_flash_attention"),
                "cli_vtn": (),
                # phase 23, FastSpeech-VC: the encoder (x4 subsampled) under
                # the gate everywhere; the decoder past it in the 30 s
                # request, in the long steps and in vc_serve's long request
                "fs2_serve": ("fused_rel_scores", "rel_flash_attention"),
                "fs2_train": ("fused_rel_scores", "rel_band_bwd"),
                "fs2_train_long": ("fused_rel_scores", "rel_band_bwd", "rel_flash_attention",
                                   *FLASH_BWD),
                "fs2_cli_train": ("fused_rel_scores", "rel_band_bwd"),
                "fs2_cli_decode": ("fused_rel_scores",),
                "fs2_cli_serve": ("fused_rel_scores", "rel_flash_attention"),
                # phase 24, Transformer-TTS and the AEPT stage: dense
                # attention everywhere but the long AEPT step's encoder
                "tts_train": (), "tts_decode": (), "tts_aept": (), "tts_finetune": (),
                "tts_aept_long": STD,
                # phase 25, the vocoders: AAS-VC's vc_decode (the 30 s
                # decoder past the gate); the VTN's conf is dense; the
                # analysis-synthesis runs no attention
                "voc_decode": ("fused_rel_scores", "rel_flash_attention"),
                "voc_vtn": (), "voc_anasyn": (),
                # phase 26, feature extraction: AAS-VC on PPG sources, every
                # length under the flash gate (the 30 s clip is 750 PPG frames)
                "feat_train": ("fused_rel_scores", "rel_band_bwd"),
                "feat_decode": ("fused_rel_scores",)}
# kernel vs plain version. Scores: float32 arithmetic on both sides (bf16
# inputs are widened), sums of D products taken in another order. Flash in
# bf16: the float32 result is rounded once to bf16 on both sides, so a
# value next to a rounding edge may differ by one bf16 ulp (2^-7 relative).
# Backward: float32 sums of up to B*T products in another order; in bf16
# the float32 result is rounded once on both sides (one ulp, 2^-7 relative).
# The flash kernels with dropout: the keep masks are the same bits on both
# sides, so the rate changes no tolerance; the flash forward's logsumexp is
# held with its output. The flash backward kernels as the rel-scores one.
TOLERANCE = {
    ("fused_rel_scores", torch.float32): dict(atol=1e-4, rtol=1e-4),
    ("fused_rel_scores", torch.bfloat16): dict(atol=1e-4, rtol=1e-4),
    ("rel_band_bwd", torch.float32): dict(atol=1e-4, rtol=1e-4),
    ("rel_band_bwd", torch.bfloat16): dict(atol=1e-2, rtol=2 ** -7),
    ("rel_flash_attention", torch.float32): dict(atol=1e-4, rtol=1e-4),
    ("rel_flash_attention", torch.bfloat16): dict(atol=1e-3, rtol=1e-2),
    **{(n, torch.float32): dict(atol=1e-4, rtol=1e-4) for n in FLASH_BWD},
    **{(n, torch.bfloat16): dict(atol=1e-2, rtol=2 ** -7) for n in FLASH_BWD},
    # the standard flash kernels as the rel-pos ones
    ("flash_attention", torch.float32): dict(atol=1e-4, rtol=1e-4),
    ("flash_attention", torch.bfloat16): dict(atol=1e-3, rtol=1e-2),
    **{(n, torch.float32): dict(atol=1e-4, rtol=1e-4) for n in STD[1:]},
    **{(n, torch.bfloat16): dict(atol=1e-2, rtol=2 ** -7) for n in STD[1:]},
}
# the legacy form as the new style (the same sums: a legacy band cell is D
# products, as a new-style one); kernels 4 and 5 as kernel 3, whose two
# outputs they are
TOLERANCE.update({(n, dt): TOLERANCE[(n.removesuffix(LEGACY_TAG), dt)]
                  for n in LEGACY for dt in (torch.float32, torch.bfloat16)})
TOLERANCE.update({(n, dt): TOLERANCE[("rel_band_bwd", dt)]
                  for n in PAIR for dt in (torch.float32, torch.bfloat16)})
REFERENCE_ATOL = 1e-3  # phase 4 waveforms, float32 on both devices
# phase 9, one float32 training step on the card and on the CPU: the loss to
# rtol 1e-4, each gradient tensor to 1e-3 of its largest magnitude (float32
# sums in other orders through eight full-width layers). The linear_k biases
# are held only to being rounding noise (under 1e-4 of the largest gradient
# on both devices): their true gradient is 0, as a softmax does not see a
# constant added to every key score. The alignment module's convs feed
# ReLUs; a pre-activation within rounding of 0 can fall on the other side
# on the other device, and then the whole gradient through that unit
# differs. The step counts such flips, and where there are any, holds the
# alignment module's own tensors to 5e-2 of their largest.
STEP_RTOL, GRAD_RTOL, NOISE_RTOL, FLIP_RTOL = 1e-4, 1e-3, 1e-4, 5e-2
# the flagship with legacy relative positions (phases 17-20)
LEGACY_CONFIG = dict(conformer_rel_pos_type="legacy")
ALIGN_RELU_INPUTS = ("t_conv1", "f_conv1", "f_conv2")

# the training settings of the same file (batch_size 16, pad_multiple 32)
TRAIN_OPT = dict(optimizer_params={"lr": 8e-5}, scheduler_params={"warmup_steps": 4000},
                 grad_norm=1.0)
TRAIN_CONFIG = dict(lambda_align=2.0, dp_train_start_steps=0, gradient_accumulate_steps=1,
                    log_interval_steps=1, seed=0)
CRITERIONS = ("L1Loss", "ForwardSumLoss", "StochasticDurationPredictorLoss")
BATCH, PAD_MULTIPLE = 16, 32
NO_DROPOUT = {k: 0.0 for k in FLAGSHIP if k.endswith("dropout_rate")}
NO_DROPOUT.update(postnet_dropout_rate=0.0, stochastic_duration_predictor_dropout_rate=0.0)
DEVICE = "cuda"  # the training path's device (a rehearsal on the CPU sets "cpu")
# the full-width model's weights: its init, then seeded noise of this scale,
# so that zero-initialised parts (flow projections, affine flows) take part
WEIGHT_NOISE = 0.02
KEY_PADDING = torch.ones(1, 1, 1, dtype=torch.bool)  # a (B, 1, T) mask, for routing
LONG_SPAN = 256  # frames above the flash gate that the long-utterance batch spreads over

# model_params of egs/arctic/vc1/conf/vtn.v1.yaml (float32 as the YAML leaves
# it), with the encoder's self-attention on the flash route; the dropouts
# are VTN's defaults (0.1, prenet 0.5)
VTN_CONFIG = dict(
    idim=80, odim=80, dprenet_layers=2, dprenet_units=256, adim=384, aheads=4, elayers=6,
    eunits=1536, dlayers=6, dunits=1536, postnet_layers=5, postnet_filts=5, postnet_chans=256,
    use_batch_norm=True, encoder_normalize_before=True, decoder_normalize_before=False,
    encoder_concat_after=False, decoder_concat_after=False, decoder_reduction_factor=4,
    attention_backend="flash",
)
# bench.py's AR decode: threshold 1.1 never stops, so every decode runs its
# whole budget of maxlenratio 4.0 (output about as long as the input)
VTN_INFERENCE = {"threshold": 1.1, "maxlenratio": 4.0, "minlenratio": 0.0}
# the 135 s request's warm-up decodes this share of its budget: every
# kernel shape but the decode steps past it, whose self-attention reads a
# longer cache prefix in the same kernels (the synthesis ladder is warmed
# on its own)
VTN_WARM_MAXLENRATIO = 0.25
VTN_NO_DROPOUT = {k: 0.0 for k in (
    "dprenet_dropout_rate", "transformer_enc_dropout_rate",
    "transformer_enc_positional_dropout_rate", "transformer_enc_attn_dropout_rate",
    "transformer_dec_dropout_rate", "transformer_dec_positional_dropout_rate",
    "transformer_dec_attn_dropout_rate")}
VTN_LONG = (8200, 9200)  # source and target frames of the long batch
VTN_REFERENCE_ATOL = 1e-3  # phase 13's features and waveforms, float32 on both devices
# the YAML's training settings beside TRAIN_OPT's (the same Adam, warmuplr
# and clipping): Seq2SeqLoss with bce_pos_weight 10, batch 16, pad multiple 32
VTN_BCE_POS_WEIGHT = 10.0
# the VTN's modules whose outputs feed a ReLU (the subsampling convs, the
# prenet's Linears, the feed-forward's first Linear): phase 16 holds a
# module's own gradients to FLIP_RTOL when one of its outputs lies on the
# other side of 0 on the other device, as phase 9 does the alignment module
VTN_RELU_INPUTS = ("embed.conv.0", "embed.conv.2", "prenet.0.0", "prenet.1.0",
                   "feed_forward.w_1")
VTN_TRAIN_CONFIG = dict(gradient_accumulate_steps=1, log_interval_steps=1, seed=0)


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def cuda_ms(fn, min_total_ms: float = 200.0, max_iters: int = 50) -> float:
    """Mean device time of ``fn`` over back-to-back launches (CUDA events),
    after one warm-up call; inputs stay where the last call left them."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    n = int(min(max_iters, max(3, min_total_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


# ---------------------------------------------------------------- kernels
def kernel_inputs(B, H, T, D, dtype, seed, lens=None, legacy=False):
    """Seeded inputs; ``lens`` are the key lengths (default: the first batch
    row sees every key, the others two thirds of them). The table is (H,
    2T-1, D), or with ``legacy`` the legacy form's (H, T, D)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    qu, qv, k, v = (rand(B, H, T, D) for _ in range(4))
    pos = rand(H, T if legacy else 2 * T - 1, D)
    if lens is None:
        lens = [T] + [max(1, 2 * T // 3)] * (B - 1)
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return qu, qv, k, v, pos, lens


def std_live(lens, Tq: int, causal: bool) -> int:
    """Live (query, key) pairs of one head: keys below each row's length
    and, causal, at or before the query."""
    if not causal:
        return Tq * int(lens.sum())
    i = torch.arange(Tq, device=lens.device)
    return int(torch.minimum(lens[:, None].long(), i[None, :] + 1).sum())


def bound(name, B, H, T, D, dtype, lens, lse=False, Tk=None, causal=False):
    """(bound_ms, bound_by): each input read once, each output written once;
    the flash kernels' work counts only the keys each batch row has (and,
    causal, the keys at or before each query). ``T`` is the query length,
    ``Tk`` the key length of the standard kernels. The legacy form counts
    its function's work, not its kernel's: a band score is D multiply-adds
    (q_v[i] or q_v[i+1] against one table row, or none), the table is (H,
    T, D), and dq_v and dpos come out D wide."""
    e = torch.finfo(dtype).bits // 8
    legacy = name.endswith(LEGACY_TAG)
    name = name.removesuffix(LEGACY_TAG)
    if name in STD:
        q_bytes = B * H * T * D * e
        kv_bytes = 2 * H * int(lens.sum()) * D * e  # k and v up to each row's keys
        live = H * std_live(lens, T, causal)
        row_stats = B * H * T * 4  # one float a row: lse, delta
        if name == "flash_attention":
            # reads q, k, v and the lengths; writes the output (and lse)
            n_bytes = 2 * q_bytes + kv_bytes + 4 * B + (row_stats if lse else 0)
            ops = 4 * live * D  # scores and P.V, 2 per multiply-add
        else:
            # reads q, dO, k, v, lse, delta and the lengths; recomputes q.k and
            # dO.v, then accumulates dq (1 more multiply-add) or dk and dv (2)
            outs = q_bytes if name == "flash_bwd_dq" else 2 * B * H * Tk * D * e
            n_bytes = 2 * q_bytes + kv_bytes + 2 * row_stats + 4 * B + outs
            ops = 2 * live * D * (3 if name == "flash_bwd_dq" else 4)
        t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
    table = H * (T if legacy else 2 * T - 1) * D * e
    qkv = B * H * T * D * e  # one (B, H, T, D) tensor
    if name == "fused_rel_scores":
        n_bytes = 3 * qkv + table + B * H * T * T * 4
        ops = 4 * B * H * T * T * D  # q_u.k and the band q_v.pos, 2 per multiply-add
    elif name == "rel_band_bwd":
        # reads g (float32), q_v and the table; writes dq_v and dpos. T*T
        # live band cells per (b, h), each in the two products
        n_bytes = B * H * T * T * 4 + 2 * (qkv + table)
        ops = 4 * B * H * T * T * D
    elif name in PAIR:
        # one of kernel 3's two products: reads g and the table (dq_v) or
        # q_v (dpos), writes the other shape
        n_bytes = B * H * T * T * 4 + qkv + table
        ops = 2 * B * H * T * T * D
    else:
        keys = int(lens.sum())
        live = H * T * keys  # live scores
        if name == "rel_flash_attention":
            # reads q_u, q_v and k, v up to each row's keys, the table and the
            # lengths; writes the output (and the logsumexp)
            n_bytes = (2 * qkv + 2 * H * keys * D * e + table + 4 * B + qkv
                       + (B * H * T * 4 if lse else 0))
            ops = 6 * live * D  # scores, band and P.V
        else:
            # reads q_u, q_v, dO, k and v, the table, lse, delta and the
            # lengths; recomputes the scores and dO.v (3D multiply-adds per
            # live score), then its outputs: dq_u and dq_v (2D more), dk and
            # dv (2D), or dpos (D)
            outs = {"rel_flash_bwd_dq": (2 * qkv, 2), "rel_flash_bwd_dkv": (2 * qkv, 2),
                    "rel_flash_bwd_dpos": (table, 1)}[name]
            n_bytes = 5 * qkv + table + 2 * B * H * T * 4 + 4 * B + outs[0]
            ops = 2 * live * D * (3 + outs[1])
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


_FWD_BWD = {}  # (shape, lens, rate) -> (port fwd+bwd ms, SDPA fwd+bwd ms)


def flash_fwd_bwd_ms(qu, qv, k, v, pos, lens, d_out, rate, legacy=False):
    """The four flash kernels' forward + backward time, and beside it the
    yardstick: SDPA's forward + backward with the band (new style, or the
    dense legacy band) materialised as a float bias (the port never calls
    SDPA). Cached per shape."""
    from seq2seq_vc_torch.ops.flash_attention import legacy_band, rel_flash_attention
    from seq2seq_vc_torch.ops.rel_scores import rel_band

    key = (tuple(qu.shape), str(qu.dtype), tuple(lens.tolist()), rate, legacy)
    if key not in _FWD_BWD:
        T, D = qu.shape[2], qu.shape[3]
        leaves = [t.detach().requires_grad_() for t in (qu, qv, k, v, pos)]
        port_ms = cuda_ms(lambda: rel_flash_attention(*leaves, lens, rate, 11, legacy=legacy)
                          .backward(d_out))
        valid = (torch.arange(T, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        band = legacy_band(qv, pos) if legacy else rel_band(qv, pos)
        bias = (band / math.sqrt(D)).masked_fill(~valid, float("-inf")).to(qu.dtype)
        q, kk, vv = leaves[0], leaves[2], leaves[3]
        sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kk, vv, attn_mask=bias, dropout_p=rate).backward(d_out))
        del bias, band, leaves
        _FWD_BWD[key] = (port_ms, sdpa_ms)
    return _FWD_BWD[key]


def check_kernel(name, B, H, T, D, dtype, seed, label, lens=None, rate=None):
    """One kernel against its plain version on the same card inputs.
    ``rate``: the flash kernels' training form, with dropout at ``rate``
    (0 included) and the forward's logsumexp; None is the serving form. A
    ``[legacy]`` name runs the rel-pos flash kernel in the legacy form, on
    q_v and the (H, T, D) table as the module holds them."""
    from seq2seq_vc_torch.ops import flash_attention as fa
    from seq2seq_vc_torch.ops import rel_scores as rs

    base, legacy = name.removesuffix(LEGACY_TAG), name.endswith(LEGACY_TAG)
    qu, qv, k, v, pos, lens = kernel_inputs(B, H, T, D, dtype, seed, lens, legacy)
    library_ms = fwd_bwd_ms = None
    drop = (rate, seed) if rate else (0.0, None)
    extra = {}
    if base == "fused_rel_scores":
        def kernel():
            return rs.fused_rel_scores(qu, qv, k, pos)

        def plain():
            return rs.fused_rel_scores_plain(qu, qv, k, pos)

        # a reference only, not the library column: q_u . k^T alone into
        # float32, half of the kernel's products, in cuBLAS
        extra["half_work_ms"] = cuda_ms(lambda: torch.matmul(qu, k.transpose(-1, -2)).float())
    elif base in ("rel_band_bwd", *PAIR):
        g = torch.randn(B, H, T, T, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(seed + 1))
        wrapper, plain_fn = getattr(rs, base), getattr(rs, base + "_plain")

        def kernel():
            return wrapper(g, qv, pos)

        def plain():
            return plain_fn(g, qv, pos)

        # yardstick only: the "xla" backward variant, the dense torch ops
        # that the kernel competes with under bwd="auto"
        library_ms = cuda_ms(lambda: rs.rel_band_bwd_xla(g, qv, pos))
    elif base == "rel_flash_attention":
        if rate is None:
            def kernel():
                return fa._fwd(qu, qv, k, v, pos, lens, 0.0, None, need_lse=False,
                               legacy=legacy)[0]

            def plain():
                return fa.rel_flash_attention_plain(qu, qv, k, v, pos, lens, legacy=legacy)
        else:
            def kernel():
                return fa._fwd(qu, qv, k, v, pos, lens, *drop, need_lse=True, legacy=legacy)

            def plain():
                return fa.rel_flash_attention_plain(qu, qv, k, v, pos, lens, *drop,
                                                    return_lse=True, legacy=legacy)

        # yardstick only: PyTorch's fused attention with the rel-pos band
        # materialised as an additive bias (the port never calls it)
        valid = (torch.arange(T, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        bias = (fa.legacy_band(qv, pos) if legacy else rs.rel_band(qv, pos)) / math.sqrt(D)
        bias = bias.masked_fill(~valid, float("-inf")).to(dtype)
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qu, k, v, attn_mask=bias, dropout_p=rate or 0.0))
        del bias
    else:
        d_out = torch.randn(qu.shape, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(seed + 2)).to(dtype)
        out, lse = fa.rel_flash_attention_plain(qu, qv, k, v, pos, lens, *drop,
                                                return_lse=True, legacy=legacy)
        args = (qu, qv, k, v, pos, lens, lse, fa._delta(out, d_out), d_out, *drop)
        wrapper, plain_fn = getattr(fa, base), getattr(fa, base + "_plain")

        def kernel():
            return wrapper(*args, legacy=legacy)

        def plain():
            return plain_fn(*args, legacy=legacy)

        fwd_bwd_ms, library_ms = flash_fwd_bwd_ms(qu, qv, k, v, pos, lens, d_out, rate or 0.0,
                                                  legacy)

    return _measure(name, label, kernel, plain, dtype, rate, lens, library_ms, fwd_bwd_ms,
                    shape=(B, H, T, D), work=B * T * T * D,
                    bound=bound(name, B, H, T, D, dtype, lens, lse=rate is not None),
                    what=f"B,H,T,D={B},{H},{T},{D}", n_kernels="four", **extra)


def _measure(name, label, kernel, plain, dtype, rate, lens, library_ms, fwd_bwd_ms, shape,
             work, bound, what, n_kernels, **extra):
    """Compare ``kernel()`` with ``plain()`` at the stated tolerance, time
    both, and return the check's row (logged)."""
    def flat(out):  # one float32 vector of a kernel's outputs
        return torch.cat([t.float().flatten() for t in out]) if isinstance(out, tuple) else out.float()

    got, want = flat(kernel()), flat(plain())
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = TOLERANCE[(name, dtype)]
    ok = bool(torch.isfinite(got).all()) and torch.allclose(got, want, **tol)
    del got, want
    ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
    bound_ms, bound_by = bound
    row = dict(name=name, label=label, shape=shape, work=work, kv_lens=lens.tolist(),
               dtype=str(dtype).split(".")[1], rate=rate,
               ok=ok, max_abs_err=err, atol=tol["atol"], rtol=tol["rtol"], ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
               library=LIBRARY[name], fwd_bwd_ms=fwd_bwd_ms, **extra)
    log(f"check {name} {label} {what} kv_lens={_short(row['kv_lens'])} "
        f"{row['dtype']}{'' if rate is None else f' rate {rate} +lse'}: "
        f"{'ok' if ok else 'FAIL'} max_abs_err={err:.3e} (atol {tol['atol']}, rtol "
        f"{tol['rtol']}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={'none' if library_ms is None else f'{library_ms:.4f}'} ({LIBRARY[name]}) "
        f"bound_ms={bound_ms:.4f} ({bound_by})"
        + ("" if fwd_bwd_ms is None
           else f"; the {n_kernels} kernels' forward + backward {fwd_bwd_ms:.4f} ms")
        + ("" if extra.get("library_bwd_ms") is None
           else f"; SDPA backward alone {extra['library_bwd_ms']:.4f} ms")
        + ("" if extra.get("half_work_ms") is None
           else f"; half_work_ms={extra['half_work_ms']:.4f} (q_u.k^T alone, torch.matmul "
                f"into float32: half the products in cuBLAS)"))
    return row


_STD_FWD_BWD = {}  # (shapes, lens, causal, rate) -> (port fwd+bwd, SDPA fwd+bwd, SDPA bwd) ms


def std_valid(lens, Tq: int, Tk: int, causal: bool):
    """(B, 1, Tq, Tk) bool: the keys each query sees (SDPA's mask)."""
    from seq2seq_vc_torch.ops.flash_attention import _valid

    return _valid(lens, Tk, lens.device, Tq, causal).expand(-1, 1, Tq, Tk)


def std_fwd_bwd_ms(q, k, v, lens, d_out, causal, rate):
    """The three standard flash kernels' forward + backward time, and beside
    it the yardsticks: SDPA's forward + backward with the key-padding mask,
    and SDPA's backward alone (``torch.autograd.grad`` on one retained
    forward with the same mask and dropout), the one call that computes
    what kernels 10 and 11 compute together (the port never calls SDPA).
    Cached per shape."""
    from seq2seq_vc_torch.ops.flash_attention import flash_attention

    key = (tuple(q.shape), tuple(k.shape), str(q.dtype), tuple(lens.tolist()), causal, rate)
    if key not in _STD_FWD_BWD:
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        port_ms = cuda_ms(lambda: flash_attention(*leaves, lens, causal, rate, 11).backward(d_out))
        valid = std_valid(lens, q.shape[2], k.shape[2], causal)
        sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            *leaves, attn_mask=valid, dropout_p=rate).backward(d_out))
        out = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=valid,
                                                               dropout_p=rate)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, d_out, retain_graph=True))
        del leaves, out
        _STD_FWD_BWD[key] = (port_ms, sdpa_ms, bwd_ms)
    return _STD_FWD_BWD[key]


def check_std_kernel(name, B, H, Tq, Tk, D, dtype, seed, label, lens=None, rate=None,
                     causal=False):
    """One standard flash kernel against its plain version on the same card
    inputs: q (B, H, Tq, D), k and v (B, H, Tk, D). ``rate``: the training
    form, with dropout at ``rate`` (0 included) and the forward's logsumexp;
    None is the serving form."""
    from seq2seq_vc_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    q, k, v = rand(B, H, Tq, D), rand(B, H, Tk, D), rand(B, H, Tk, D)
    lens = torch.tensor([Tk] + [max(1, 2 * Tk // 3)] * (B - 1) if lens is None else lens,
                        dtype=torch.int32, device="cuda")
    drop = (rate, seed) if rate else (0.0, None)
    fwd_bwd_ms = library_bwd_ms = None
    if name == "flash_attention":
        if rate is None:
            def kernel():
                return fa.flash_attention(q, k, v, lens, causal)

            def plain():
                return fa.flash_attention_plain(q, k, v, lens, causal)
        else:
            def kernel():
                return fa._std_fwd(q, k, v, lens, causal, *drop, need_lse=True)

            def plain():
                return fa.flash_attention_plain(q, k, v, lens, causal, *drop, return_lse=True)

        # yardstick only: PyTorch's fused attention with the same mask
        valid = std_valid(lens, Tq, Tk, causal)
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=valid, dropout_p=rate or 0.0))
        del valid
    else:
        d_out = torch.randn(q.shape, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(seed + 2)).to(dtype)
        out, lse = fa.flash_attention_plain(q, k, v, lens, causal, *drop, return_lse=True)
        args = (q, k, v, lens, lse, fa._delta(out, d_out), d_out, causal, *drop)
        wrapper, plain_fn = getattr(fa, name), getattr(fa, name + "_plain")

        def kernel():
            return wrapper(*args)

        def plain():
            return plain_fn(*args)

        fwd_bwd_ms, library_ms, library_bwd_ms = std_fwd_bwd_ms(q, k, v, lens, d_out, causal,
                                                                rate or 0.0)
    return _measure(name, label, kernel, plain, dtype, rate, lens, library_ms, fwd_bwd_ms,
                    shape=(B, H, Tq, D), work=B * Tq * Tk * D,
                    bound=bound(name, B, H, Tq, D, dtype, lens, lse=rate is not None, Tk=Tk,
                                causal=causal),
                    what=f"B,H,Tq,Tk,D={B},{H},{Tq},{Tk},{D}{' causal' if causal else ''}",
                    n_kernels="three", tk=Tk, causal=causal, library_bwd_ms=library_bwd_ms)


def _short(lens):
    """Key lengths for a log line: all of them, or their range if many."""
    return lens if len(lens) <= 4 else f"{len(lens)} in [{min(lens)}, {max(lens)}]"


# ------------------------------------------------------------- main path
def clip(seconds: float, seed: int, sr: int = FEATS["sampling_rate"]) -> np.ndarray:
    """A voiced-speech-like test signal at ``sr``: a gliding harmonic series
    under a syllable-rate envelope, plus a little noise."""
    t = np.arange(int(sr * seconds)) / sr
    rng = np.random.default_rng(seed)
    f0 = 110 + 25 * rng.random() + 30 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(h * phase) / h for h in range(1, 9))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t + rng.random() * 6.28)
    x = 0.15 * env * voiced + 0.01 * rng.standard_normal(t.shape)
    return x.astype(np.float32)


def perturb_(module: torch.nn.Module, seed: int) -> None:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(WEIGHT_NOISE * torch.randn(p.shape, generator=g).to(p.device, p.dtype))


def build_models(seed: int, **over):
    """The flagship AAS-VC (``over`` replaces config fields) and the serving
    HiFi-GAN on the CPU, seeded."""
    from seq2seq_vc_torch.models.aas_vc import AASVC

    torch.manual_seed(seed)
    model = AASVC(**dict(FLAGSHIP, **over))
    perturb_(model, seed)
    return model.eval(), build_vocoder(seed + 1)


def build_vocoder(seed: int):
    """The serving HiFi-GAN on the CPU: its init from torch's default
    generator, then seeded noise."""
    from seq2seq_vc_torch.vocoder.hifigan import HifiganGenerator

    vocoder = HifiganGenerator(**HIFIGAN)
    perturb_(vocoder, seed)
    return vocoder.eval()


def stats(seed: int):
    rng = np.random.default_rng(seed)
    return {"mean": (-4 + rng.standard_normal(80)).astype(np.float32),
            "scale": (1 + 0.5 * rng.random(80)).astype(np.float32)}


def inference_calls(m, T_enc, enc_lens, T_dec, dec_lens):
    """The attention calls one ``AASVC.inference`` or
    ``FastSpeechVC.inference`` batch makes: (kernel name, B, H, T, D, key
    lengths) for each conformer layer, from its routing, with the encoder
    input at ``T_enc`` frames (after frame stacking; a conv2d input layer
    subsamples it) and the decoder at ``T_dec``, its key lengths at most
    that (FastSpeech-VC's output lengths are not clamped)."""
    from seq2seq_vc_torch.models.common import conv2d_subsampled_lengths as subsampled

    if getattr(m, "encoder_input_layer", None) == "conv2d":
        T_enc, enc_lens = subsampled(T_enc), [subsampled(n) for n in enc_lens]
    dec_lens = [min(n, T_dec) for n in dec_lens]
    calls = []
    for stack, T, lens in ((m.encoder, T_enc, enc_lens), (m.decoder, T_dec, dec_lens)):
        for layer in stack.encoders:
            att = layer.self_attn
            path = att.route(T, T, T if att.legacy else 2 * T - 1, KEY_PADDING)
            name = {"fused": "fused_rel_scores", "flash": "rel_flash_attention"}.get(path)
            if name:
                name += LEGACY_TAG if att.legacy else ""
                calls.append((name, len(lens), att.n_head, T, att.d_k, tuple(lens)))
    return calls


def planned_calls(conv, requests, out_frames):
    """For each request, the attention calls its conformer layers make,
    from the converter's frame geometry, the input lengths and the output
    lengths ``out_frames`` that a run of the same requests gave."""
    from seq2seq_vc_torch.dsp.stft import num_frames

    m = conv.model
    calls = []
    for (_, clips), outs in zip(requests, out_frames):
        padded = [len(c) + 2 * (conv.fft_size // 2) for c in clips]
        n_padded, _, max_out = conv._frame_geometry(padded)
        calls += inference_calls(
            m, n_padded // m.encoder_reduction_factor,
            [num_frames(len(c), conv.hop_size) // m.encoder_reduction_factor for c in clips],
            max_out, [n // m.decoder_reduction_factor for n in outs])
    return calls


def decode_calls(model, scp, batch_size, outdir):
    """The attention calls of a ``vc_decode`` run of ``scp`` at
    ``batch_size`` (NAR, no teacher forcing): its batches as the driver
    forms them, each padded to the driver's frame multiple, the decoder at
    twice the padded source frames (the driver's ``max_output_frames``),
    and the output lengths the run wrote to ``outdir``."""
    from seq2seq_vc_torch.bin.vc_decode import decode_batches, frame_multiple
    from seq2seq_vc_torch.train.data import SourceVCMelDataset

    data = SourceVCMelDataset(scp)
    multiple = frame_multiple(model)
    erf, drf = model.encoder_reduction_factor, model.decoder_reduction_factor
    calls = []
    for group in decode_batches(data, batch_size):
        src = [data.length(i) for i in group]
        T_in = -(-max(src) // multiple) * multiple
        outs = [np.load(Path(outdir) / f"{data.utt_ids[i]}.npy", mmap_mode="r").shape[0]
                for i in group]
        calls += inference_calls(model, T_in // erf, [n // erf for n in src], 2 * T_in,
                                 [n // drf for n in outs])
    return calls


def serving_requests():
    """The AAS-VC serving requests: a 3.8 s clip, a batch of 4 and a 30 s
    clip whose decoder key length crosses the flash gate."""
    return [
        ("single 3.8 s", [clip(3.8, 10)]),
        ("batch of 4", [clip(s, 11 + i) for i, s in enumerate((2.2, 3.0, 3.8, 4.6))]),
        ("single 30 s", [clip(30.0, 15)]),
    ]


def serve(conv, requests):
    """Drive the converter through its entry points. Returns the failures
    and, for each request, its latency and output lengths in frames."""
    failures, results = [], []
    sr = FEATS["sampling_rate"]
    for label, clips in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wavs = [conv(clips[0])] if len(clips) == 1 else conv.convert_batch(clips)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        secs = sum(len(c) for c in clips) / sr
        lens = [len(w) for w in wavs]
        ok = all(n > 0 and n % conv.hop_size == 0 and np.isfinite(w).all()
                 for n, w in zip(lens, wavs))
        steps = getattr(conv, "last_decode_steps", None)
        log(f"request {label}: {len(clips)} clip(s), {secs:.2f} s of audio, latency "
            f"{dt * 1e3:.1f} ms, RTF {dt / secs:.5f}, output samples {lens} "
            f"(multiples of {conv.hop_size}, finite: {'yes' if ok else 'NO'})"
            + ("" if steps is None else f"; {steps} AR steps, {steps / dt:.1f} steps/s"))
        if not ok:
            failures.append(f"request {label}: bad output {lens}")
        results.append(dict(ms=dt * 1e3, out_frames=[n // conv.hop_size for n in lens]))
    return failures, results


def trace_kernels(prof):
    """(name, ms, count) of each device activity in a trace, summed from its
    raw events: building the profiler's event tree (``key_averages``) takes
    minutes for a long AR decode's ~10^6 events."""
    acc = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0:
            ms, n = acc.get(e.name(), (0.0, 0))
            acc[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return [(name, ms, n) for name, (ms, n) in acc.items()]


def profile_request(conv, request, latency_ms,
                    port_kernels=("rel_scores_fwd_kernel", "rel_flash_fwd_kernel")):
    """Device time by kernel for one request (torch.profiler, CUPTI), beside
    the request's untraced latency: what the device does and how much of the
    request it is busy."""
    from torch.profiler import ProfilerActivity, profile

    label, clips = request
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        conv.convert_batch(clips)
        torch.cuda.synchronize()
    kernels = trace_kernels(prof)
    busy = sum(ms for _, ms, _ in kernels)
    if busy == 0:
        log(f"profile {label}: the trace holds no device time: not measured")
        return
    port = {n: sum(ms for k, ms, _ in kernels if n in k) for n in port_kernels}
    log(f"profile {label}: device busy {busy:.3f} ms in kernels; untraced latency "
        f"{latency_ms:.1f} ms, so busy share {busy / latency_ms:.3f}; port kernels (ms) {port}")
    for key, ms, n in sorted(kernels, key=lambda r: -r[1])[:12]:
        log(f"  {ms:9.3f} ms {ms / busy:6.1%} x{n:<4d} {key[:100]}")


def launch_counters():
    """Each kernel's launch counter, by name: (wrapper, attribute). The
    legacy form of the rel-pos flash kernels counts in its wrapper's
    ``legacy_launches``."""
    from seq2seq_vc_torch.ops import flash_attention as fa
    from seq2seq_vc_torch.ops import rel_scores as rs

    wrappers = {n: getattr(rs, n) for n in ("fused_rel_scores", "rel_band_bwd", *PAIR)}
    wrappers.update({n: getattr(fa, n) for n in ("rel_flash_attention", *FLASH_BWD, *STD)})
    counters = {n: (fn, "launches") for n, fn in wrappers.items()}
    counters.update({n: (wrappers[n.removesuffix(LEGACY_TAG)], "legacy_launches") for n in LEGACY})
    return counters


def launch_counts():
    return {name: getattr(fn, attr) for name, (fn, attr) in launch_counters().items()}


def reset_launch_counts():
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)


def reference_check(model, vocoder, src, trg, path="serve", **over):
    """Float32 copies of the same weights (``over`` replaces config fields
    of the flagship, as for ``model``) convert one clip on the card and on
    the CPU; the decoder's flash gate is lowered so that the kernels of
    ``path`` (and on the CPU their plain versions) run, and no other. One
    CPU generator draws the duration noise for both."""
    from seq2seq_vc_torch.models.aas_vc import AASVC
    from seq2seq_vc_torch.pipeline import Wav2WavConverter

    m32 = AASVC(**dict(FLAGSHIP, compute_dtype="float32", flash_min_len=256, **over))
    m32.load_state_dict(model.state_dict())
    v32 = copy.deepcopy(vocoder)
    v32.compute_dtype = torch.float32
    audio = clip(1.0, seed=7)
    wavs, counts = {}, {}
    for dev in ("cuda", "cpu"):
        conv = Wav2WavConverter(copy.deepcopy(m32), copy.deepcopy(v32), src, trg, FEATS,
                                device=dev)
        before = launch_counts()
        wavs[dev] = conv(audio, generator=torch.Generator().manual_seed(0))
        counts[dev] = {k: v - before[k] for k, v in launch_counts().items()}
    a, b = wavs["cuda"], wavs["cpu"]
    same_len = len(a) == len(b)
    err = float(np.abs(a - b).max()) if same_len else float("inf")
    others = set(KERNELS) - set(PATH_KERNELS[path])
    ok = same_len and err <= REFERENCE_ATOL \
        and all(counts["cuda"][n] for n in PATH_KERNELS[path]) \
        and not any(counts["cuda"][n] for n in others) and not any(counts["cpu"].values())
    log(f"reference float32 1.0 s clip ({path}): card {len(a)} samples, cpu {len(b)} samples, "
        f"max abs diff {err:.3e} (atol {REFERENCE_ATOL}); launches card {counts['cuda']}, "
        f"cpu {counts['cpu']}: {'ok' if ok else 'FAIL'}")
    return [] if ok else [f"reference check: card vs cpu diff {err}, lengths {len(a)} {len(b)}"]


# ---------------------------------------------------------- training path
def flagship(seed: int, **over):
    """The flagship AAS-VC on the CPU in train() mode, seeded as
    ``build_models`` seeds it; ``over`` replaces config fields."""
    from seq2seq_vc_torch.models.aas_vc import AASVC

    torch.manual_seed(seed)
    model = AASVC(**dict(FLAGSHIP, **over))
    perturb_(model, seed)
    return model.train()


def train_state(model):
    """The flagship's optimizer around ``model``: Adam on warmuplr, clipping."""
    from seq2seq_vc_torch.train.optim import build_optimizer
    from seq2seq_vc_torch.train.state import TrainState

    return TrainState(model, build_optimizer(model.parameters(), **TRAIN_OPT))


def make_trainer(state, loader, steps: int, device=None):
    """An ``AASVCTrainer`` that takes ``steps`` more optimizer steps on
    ``state`` (the same ``Trainer`` that a training CLI builds)."""
    from seq2seq_vc_torch.losses import get_criterion
    from seq2seq_vc_torch.train.aas_vc import AASVCTrainer

    config = dict(TRAIN_CONFIG, train_max_steps=state.steps + steps)
    return AASVCTrainer(state, {n: get_criterion(n) for n in CRITERIONS}, config, loader,
                        device=device or DEVICE)


def corpus_lens(lo: int, hi: int, seed: int):
    """BATCH (source, target) frame counts: targets spread evenly over
    [lo, hi], each source 80-100% of its target (parallel utterances)."""
    trg = np.linspace(lo, hi, BATCH).round().astype(int)
    src = (trg * np.random.default_rng(seed).uniform(0.8, 1.0, BATCH)).astype(int)
    return list(zip(src.tolist(), trg.tolist()))


def feature_items(lens, seed: int):
    """Dataset items of log-mel-like random features (80 bins) with the
    given (source, target) frame counts."""
    rng = np.random.default_rng(seed)
    items = []
    for i, (n_src, n_trg) in enumerate(lens):
        src, trg = ((-4 + rng.standard_normal((n, 80))).astype(np.float32) for n in (n_src, n_trg))
        items.append({"utt_id": f"utt{i:03d}", "src_feat": src, "trg_feat": trg, "dp_input": src})
    return items


def corpus_loader(root: Path, lens, seed: int, collater=None):
    """A synthetic parallel corpus written as ``.npy`` files with one scp
    per side, read back through the port's dataset, collater and loader
    (the flagship's batch size and padding; the duration predictor reads
    the source mel, as ``duration_predictor_feat: mel`` says). ``collater``
    replaces the flagship's NAR collater (and then no duration-predictor
    input is read)."""
    from seq2seq_vc_torch.train.data import DataLoader, NARVCCollater, ParallelVCMelDataset

    root.mkdir(parents=True, exist_ok=True)
    scp = {"src_feat": [], "trg_feat": []}
    for item in feature_items(lens, seed):
        for key in scp:
            path = root / f"{key}_{item['utt_id']}.npy"
            np.save(path, item[key])
            scp[key].append(f"{item['utt_id']} {path}")
    for key, lines in scp.items():
        (root / f"{key}.scp").write_text("\n".join(lines) + "\n")
    src, trg = (str(root / f"{key}.scp") for key in scp)
    if collater is not None:
        return DataLoader(ParallelVCMelDataset(src, trg), collater, BATCH, seed=seed)
    collater = NARVCCollater(PAD_MULTIPLE, FLAGSHIP["encoder_reduction_factor"],
                             FLAGSHIP["post_encoder_reduction_factor"],
                             FLAGSHIP["decoder_reduction_factor"])
    return DataLoader(ParallelVCMelDataset(src, trg, dp_feats=src), collater, BATCH, seed=seed)


def train_calls(model, batch):
    """The kernel launches one training step on ``batch`` makes: (kernel
    name, B, H, T, D, key lengths) for each fused forward and each banded
    backward (or kernels 4 and 5 for ``bwd="pallas"``), and for each flash
    forward and its three backward kernels (in the legacy form for a legacy
    layer), from each layer's routing and its ``bwd`` variant at the padded
    lengths (the fused kernels take no key lengths: all T there)."""
    from seq2seq_vc_torch.models.common import conv2d_subsampled_lengths as subsampled
    from seq2seq_vc_torch.ops.rel_scores import resolve_bwd

    B = len(batch["ilens"])
    m = model
    conv2d = getattr(m, "encoder_input_layer", None) == "conv2d"  # x4 subsampling
    calls = []
    for stack, T, lens in (
        (m.encoder, batch["xs"].shape[1] // m.encoder_reduction_factor,
         batch["ilens"] // m.encoder_reduction_factor),
        (m.decoder, batch["ys"].shape[1] // m.decoder_reduction_factor,
         batch["olens"] // m.decoder_reduction_factor),
    ):
        if conv2d and stack is m.encoder:
            T, lens = subsampled(T), [subsampled(int(n)) for n in lens]
        lens = tuple(int(n) for n in lens)
        for layer in stack.encoders:
            att = layer.self_attn
            shape = (B, att.n_head, T, att.d_k)
            path = att.route(T, T, T if att.legacy else 2 * T - 1, KEY_PADDING)
            if path == "flash":
                names = PATH_KERNELS["train_long_legacy" if att.legacy else "train_long"]
                calls += [(n, *shape, lens) for n in names]
            elif path == "fused":
                bwd = {"banded": ("rel_band_bwd",), "pallas": PAIR}.get(
                    resolve_bwd(att.rel_scores_bwd, T), ())
                calls += [(n, *shape, (T,) * B) for n in ("fused_rel_scores", *bwd)]
    return calls


def watch_grads(state):
    """Before each Adam update (after clipping), note on the device whether
    every gradient is finite and the smallest norm among the attention
    projections' weight gradients. Returns the notes, the hook's handle and
    the number of projections watched."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    params = state.optimizer.params
    att = [p for p in params
           if ".self_attn.linear_" in names[id(p)] and names[id(p)].endswith(".weight")]
    notes = []

    def hook(adam, args, kwargs):
        norms = torch.stack(torch._foreach_norm([p.grad for p in params]))
        att_norms = torch.stack(torch._foreach_norm([p.grad for p in att]))
        notes.append((torch.isfinite(norms).all(), att_norms.min()))

    return notes, state.optimizer.adam.register_step_pre_hook(hook), len(att)


def train_steps(state, loader, steps: int, label: str, make=make_trainer):
    """``steps`` optimizer steps through the trainer that ``make`` builds;
    logs each step's time and loss terms from the trainer's own log.
    Returns the trainer."""
    trainer = make(state, loader, steps)
    trainer.run()
    for h in trainer.history:
        terms = ", ".join(f"{k[len('train/'):-len('_loss')]} {v:.4f}" for k, v in h.items()
                          if k.endswith("_loss"))
        log(f"train {label} step {h['steps']}: {h['train/step_time_sec'] * 1e3:.1f} ms, "
            f"loss {h['train/loss']:.4f} ({terms}), grad norm {h['train/grad_norm']:.4f}")
    return trainer


def time_mas(batch, label: str):
    """The MAS loop alone on the card at one step's shape: mean host time
    of ``viterbi_decode`` (each call ends in a sync) over 3 calls."""
    from seq2seq_vc_torch.ops.mas import viterbi_decode

    r = FLAGSHIP["encoder_reduction_factor"] * FLAGSHIP["post_encoder_reduction_factor"]
    t_text, t_feats = batch["xs"].shape[1] // r, batch["ys"].shape[1]
    ilens = torch.tensor(batch["ilens"] // r, device=DEVICE)
    olens = torch.tensor(batch["olens"], device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    lp = torch.log_softmax(torch.randn(len(ilens), t_feats, t_text, device=DEVICE, generator=g), -1)
    viterbi_decode(lp, ilens, olens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        viterbi_decode(lp, ilens, olens)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 3 * 1e3
    log(f"MAS alone {label}: viterbi_decode on ({len(ilens)}, {t_feats}, {t_text}) "
        f"log-probs: {ms:.1f} ms a call (host clock, synced)")
    return ms


def profile_step(state, loader, step_ms: float, label: str,
                 port_kernels=("rel_scores_fwd_kernel", "rel_scores_bwd_kernel"),
                 make=make_trainer):
    """Device time by kernel over one training step (torch.profiler),
    beside the untraced step time; ``port_kernels`` are summed by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        make(state, loader, 1).run()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    if busy == 0:
        log("profile train step: the trace holds no device time: not measured")
        return
    port = {n: round(sum(ms for k, ms, _ in kernels if n in k), 3) for n in port_kernels}
    log(f"profile train step ({label}): device busy {busy:.3f} ms in "
        f"kernels; untraced step {step_ms:.1f} ms, so busy share {busy / step_ms:.3f}; "
        f"port kernels (ms) {port}")
    for key, ms, n in sorted(kernels, key=lambda r: -r[1])[:12]:
        log(f"  {ms:9.3f} ms {ms / busy:6.1%} x{n:<5d} {key[:100]}")


def reference_step(seed: int, path: str = "train"):
    """One float32 training step's loss and gradients, from the same
    weights and batch, on the card (through the kernels of ``path``) and on
    the CPU (through their plain versions), dropout off. ``path`` "train":
    the fused route (kernels 1 and 3); "train_long": the flash gate lowered
    below the batch's lengths, so that every layer takes the flash route
    (kernels 2, 6, 7 and 8); "train_long_legacy": the same in the legacy
    form. The trainer's own CPU generator draws the duration predictor's
    e_q, the same on both."""
    from seq2seq_vc_torch.train.data import NARVCCollater

    route = {"train": dict(rel_scores_bwd="banded"), "train_long": dict(flash_min_len=64),
             "train_long_legacy": dict(flash_min_len=64, **LEGACY_CONFIG)}[path]
    model = flagship(seed, compute_dtype="float32", **route, **NO_DROPOUT)
    collater = NARVCCollater(PAD_MULTIPLE, 1, FLAGSHIP["post_encoder_reduction_factor"], 1)
    batch = collater(feature_items([(128, 128), (100, 112)], seed))
    runs = {}
    for side, dev in (("card", DEVICE), ("cpu", "cpu")):
        trainer = make_trainer(train_state(copy.deepcopy(model)), [], 1, device=dev)
        pre = {}  # the alignment module's ReLU inputs
        for name in ALIGN_RELU_INPUTS:
            getattr(trainer.model.alignment_module, name).register_forward_hook(
                lambda mod, args, out, name=name: pre.__setitem__(name, out.detach().cpu()))
        before = launch_counts()
        loss, metrics = trainer.loss_fn(trainer._array_batch(batch), trainer._flags(),
                                        trainer.generator)
        loss.backward()
        grads = {n: p.grad.detach().float().cpu() for n, p in trainer.model.named_parameters()
                 if p.grad is not None}
        counts = {k: v - before[k] for k, v in launch_counts().items()}
        runs[side] = (loss.item(), {k: v.item() for k, v in metrics.items()}, grads, counts, pre)
    (la, ma, ga, ca, pa), (lb, mb, gb, cb, pb) = runs["card"], runs["cpu"]
    flips = {n: [float(v) for v in pb[n][(pa[n] > 0) != (pb[n] > 0)]] for n in ALIGN_RELU_INPUTS}
    failures = []
    for name, a, b in [("loss", la, lb)] + [(k, ma[k], mb[k]) for k in mb]:
        if not (math.isfinite(a) and abs(a - b) <= STEP_RTOL * abs(b)):
            failures.append(f"reference step {name}: card {a} cpu {b}")
    if set(ga) != set(gb):
        failures.append(f"reference step: gradients of {sorted(set(ga) ^ set(gb))} on one side only")
    top = max(float(g.abs().max()) for g in gb.values())
    worst = {}  # the largest error in the alignment module and elsewhere, with its tensor
    for name in sorted(set(ga) & set(gb)):
        a, b = ga[name], gb[name]
        if name.endswith("linear_k.bias"):
            if max(float(a.abs().max()), float(b.abs().max())) > NOISE_RTOL * top:
                failures.append(f"reference step {name}: not rounding noise")
            continue
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        part = "alignment" if name.startswith("alignment_module.") else "rest"
        worst[part] = max(worst.get(part, (0.0, "")), (rel, name))
        tol = FLIP_RTOL if part == "alignment" and any(flips.values()) else GRAD_RTOL
        if not (torch.isfinite(a).all() and rel <= tol):
            failures.append(f"reference step {name}: gradient error {rel:.3e} of its largest")
    others = set(KERNELS) - set(PATH_KERNELS[path])
    if not all(ca[n] for n in PATH_KERNELS[path]) or any(ca[n] for n in others) or any(cb.values()):
        failures.append(f"reference step launches: card {ca}, cpu {cb}")
    log(f"reference float32 train step, {path} route (B 2, T 128, dropout off, same e_q): "
        f"loss card {la:.6f} "
        f"cpu {lb:.6f}; terms card {ma} cpu {mb}; {len(gb)} gradient tensors, worst error of "
        f"a tensor's largest: {worst} (rtol {GRAD_RTOL}; alignment module {FLIP_RTOL} if a "
        f"ReLU flipped); alignment ReLU inputs on opposite sides of 0 (cpu values): {flips}; "
        f"launches card {ca}, cpu {cb}: {'ok' if not failures else 'FAIL'}")
    return failures


def train_path(rows):
    """Phases 7-9: the training path. Appends the kernel checks to ``rows``;
    returns (failures, launches of the timed steps, by kernel)."""
    failures = []
    tmp = REPO / "build"
    tmp.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=tmp, prefix="chip_smoke_corpus_") as root:
        loaders = {T: corpus_loader(Path(root) / f"T{T}", corpus_lens(lo, T, seed=T), seed=T)
                   for lo, T in ((160, 512), (480, 960))}
        batches = {T: next(iter(loader)) for T, loader in loaders.items()}
        state = train_state(flagship(seed=3).to(DEVICE))
        log(f"training: AASVCTrainer, flagship at full width (bf16, dropout 0.2), B{BATCH}; "
            f"batch shapes (xs, ys): { {T: (b['xs'].shape, b['ys'].shape) for T, b in batches.items()} }")
        log("training warm-up: one step")
        train_steps(state, loaders[512], 1, "warm-up")

        calls = {T: train_calls(state.model, b) for T, b in batches.items()}
        for D, T in ((192, 640), (768, 1300)):
            for dtype in (torch.float32, torch.bfloat16):
                rows.append(check_kernel("rel_band_bwd", 2, 2, T, D, dtype, seed=T + D,
                                         label="head-dim"))
        for name, B, H, T, D, lens in sorted({c for cs in calls.values() for c in cs}):
            rows.append(check_kernel(name, B, H, T, D, torch.bfloat16, seed=T + D,
                                     label="main-path", lens=list(lens)))

        log("training main path: 3 steps at T 512, then 2 at T 960")
        notes, handle, n_att = watch_grads(state)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        short = train_steps(state, loaders[512], 3, "T512")
        long_ = train_steps(state, loaders[960], 2, "T960")
        launches = launch_counts()
        handle.remove()
        expected = {n: 3 * sum(c[0] == n for c in calls[512]) + 2 * sum(c[0] == n for c in calls[960])
                    for n in KERNELS}
        step_ms = {T: float(np.mean([h["train/step_time_sec"] for h in t.history])) * 1e3
                   for T, t in ((512, short), (960, long_))}
        log(f"training: ms/step {step_ms}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}, "
            f"expected from the routing {expected}")
        for name in KERNELS:
            if launches[name] != expected[name] or (launches[name] == 0 and name in PATH_KERNELS["train"]):
                failures.append(f"train {name}: {launches[name]} launches, expected {expected[name]}")
        losses = [h["train/loss"] for t in (short, long_) for h in t.history]
        if not all(math.isfinite(x) for x in losses):
            failures.append(f"train: loss not finite: {losses}")
        finite = [bool(f) for f, _ in notes]
        att_min = [float(m) for _, m in notes]
        log(f"training gradients per step: all finite {finite}; smallest norm among the "
            f"{n_att} attention projections' weight gradients {att_min}")
        if len(notes) != 5 or not all(finite) or not all(m > 0 for m in att_min):
            failures.append(f"train: gradients finite {finite}, attention grad norms {att_min}")

        time_mas(batches[512], "T512")
        time_mas(batches[960], "T960")
        profile_step(state, loaders[512], step_ms[512], f"B{BATCH}, T 512")
        profile_step(state, loaders[960], step_ms[960], f"B{BATCH}, T 960")
    failures += reference_step(seed=4)
    return failures, launches


def long_lens(seed: int):
    """BATCH (source, target) frame counts over [FLASH_MIN_LEN, FLASH_MIN_LEN
    + LONG_SPAN] (2048-2304 frames: 33-37 s of 16 kHz audio at hop 256):
    targets spread evenly, sources the same lengths shuffled, so that both
    stacks pad to the top of the range and cross the flash gate."""
    from seq2seq_vc_torch.nn.attention import FLASH_MIN_LEN

    trg = np.linspace(FLASH_MIN_LEN, FLASH_MIN_LEN + LONG_SPAN, BATCH).round().astype(int)
    src = np.random.default_rng(seed).permutation(trg)
    return list(zip(src.tolist(), trg.tolist()))


def train_long_path(rows, path="train_long"):
    """Phases 10-11 (``path`` "train_long"): long-utterance training through
    the flash kernels, 3 timed steps; phases 19-20 ("train_long_legacy"):
    the legacy flagship, through the flash kernels' legacy form, 2 timed
    steps. Appends the kernel checks to ``rows``; returns (failures,
    launches of the timed steps, by kernel)."""
    failures = []
    legacy = path == "train_long_legacy"
    steps = 2 if legacy else 3
    tmp = REPO / "build"
    tmp.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=tmp, prefix=f"chip_smoke_{path}_") as root:
        loader = corpus_loader(Path(root), long_lens(seed=6), seed=6)
        batch = next(iter(loader))
        state = train_state(flagship(seed=45 if legacy else 5,
                                     **(LEGACY_CONFIG if legacy else {})).to(DEVICE))
        label = f"T{batch['xs'].shape[1]}/{batch['ys'].shape[1]}"
        log(f"{path}: AASVCTrainer, flagship at full width (bf16, dropout 0.2"
            f"{', legacy relative positions' if legacy else ''}), "
            f"B{BATCH}; sources {sorted(batch['ilens'].tolist())}, targets "
            f"{sorted(batch['olens'].tolist())} frames, padded (xs, ys) "
            f"{batch['xs'].shape}, {batch['ys'].shape}")
        log(f"{path} warm-up: one step")
        train_steps(state, loader, 1, f"{path} warm-up")

        calls = train_calls(state.model, batch)
        for D, T in ((192, 640), (768, 1300)):
            for dtype in (torch.float32, torch.bfloat16):
                for rate in (0.0, 0.2):
                    for name in PATH_KERNELS[path]:
                        rows.append(check_kernel(name, 3, 2, T, D, dtype, seed=T + D,
                                                 label="head-dim", lens=[T, 2 * T // 3, 0],
                                                 rate=rate))
        for name, B, H, T, D, lens in sorted(set(calls)):
            rows.append(check_kernel(name, B, H, T, D, torch.bfloat16, seed=T + D,
                                     label="main-path", lens=list(lens), rate=0.2))

        log(f"{path} main path: {steps} steps at {label}")
        notes, handle, n_att = watch_grads(state)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        trainer = train_steps(state, loader, steps, label)
        launches = launch_counts()
        handle.remove()
        expected = {n: steps * sum(c[0] == n for c in calls) for n in KERNELS}
        step_ms = [h["train/step_time_sec"] * 1e3 for h in trainer.history]
        log(f"{path}: ms/step {[round(x, 1) for x in step_ms]} (mean "
            f"{np.mean(step_ms):.1f}); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}, "
            f"expected from the routing {expected}")
        for name in KERNELS:
            want = expected[name]
            if launches[name] != want or (launches[name] == 0 and name in PATH_KERNELS[path]):
                failures.append(f"{path} {name}: {launches[name]} launches, expected {want}")
        if any(expected[n] != steps * 8 for n in PATH_KERNELS[path]):
            failures.append(f"{path}: the routing does not put all 8 layers on flash: {expected}")
        losses = [h["train/loss"] for h in trainer.history]
        if not all(math.isfinite(x) for x in losses):
            failures.append(f"{path}: loss not finite: {losses}")
        finite = [bool(f) for f, _ in notes]
        att_min = [float(m) for _, m in notes]
        log(f"{path} gradients per step: all finite {finite}; smallest norm among the "
            f"{n_att} attention projections' weight gradients {att_min}")
        if len(notes) != steps or not all(finite) or not all(m > 0 for m in att_min):
            failures.append(f"{path}: gradients finite {finite}, attention grad norms {att_min}")
        profile_step(state, loader, float(np.mean(step_ms)), f"B{BATCH}, {label}",
                     port_kernels=("rel_flash_fwd_kernel", "rel_flash_bwd_dq_kernel",
                                   "rel_flash_bwd_dkv_kernel", "rel_flash_bwd_dpos_kernel",
                                   "rel_flash_bwd_dpos_sum_kernel"))
        del state, trainer
    failures += reference_step(seed=46 if legacy else 8, path=path)
    return failures, launches


# --------------------------------------------------------------- VTN paths
def vtn_model(seed: int, **over):
    """The full-width VTN on the CPU, seeded as ``flagship`` seeds the
    AAS-VC; ``over`` replaces config fields."""
    from seq2seq_vc_torch.models.vtn import VTN

    torch.manual_seed(seed)
    model = VTN(**dict(VTN_CONFIG, **over))
    perturb_(model, seed)
    return model


def vtn_encoder_calls(model, n_padded: int, n_trues):
    """The standard flash forward calls the VTN encoder makes on a batch
    padded to ``n_padded`` frames with true lengths ``n_trues``: (B, H, T,
    D, key lengths) for each layer on the flash route, with T and the key
    lengths after the x4 subsampling (Conv2dSubsampling's mask slicing)."""
    T = ((n_padded - 1) // 2 - 1) // 2
    mask = torch.arange(n_padded)[None, :] < torch.as_tensor(list(n_trues))[:, None]
    lens = tuple(int(n) for n in mask[:, :-2:2][:, :-2:2].sum(-1))
    return [(len(lens), layer.self_attn.n_head, T, layer.self_attn.d_k, lens)
            for layer in model.encoder.encoders
            if layer.self_attn.route(T, KEY_PADDING) == "flash"]


def vtn_request_calls(conv, clips):
    """``vtn_encoder_calls`` of one request, from the converter's padding."""
    batch, n_trues = conv._prepare(clips)
    return vtn_encoder_calls(conv.model, 1 + (batch.shape[1] - conv.fft_size) // conv.hop_size,
                             n_trues)


def std_head_dim_checks(rows, names):
    """The standard flash kernels ``names`` against their plain versions at
    the VTN's head dim (4 heads of D 96): float32 and bfloat16, causal off
    and on, the serving form (kernel 9 only) and the training form at rate
    0 and 0.2, at T 640 with key padding and a fully masked batch row; and
    at two cross shapes, fewer queries than keys and more."""
    for name in names:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                for rate in ((None, 0.0, 0.2) if name == "flash_attention" else (0.0, 0.2)):
                    rows.append(check_std_kernel(name, 3, 4, 640, 640, 96, dtype, seed=640,
                                                 label="head-dim", lens=[640, 426, 0],
                                                 rate=rate, causal=causal))
            for Tq, Tk, causal in ((320, 640, False), (640, 200, True)):
                rows.append(check_std_kernel(name, 3, 4, Tq, Tk, 96, dtype, seed=Tq + Tk,
                                             label="cross", lens=[Tk, 2 * Tk // 3, 0],
                                             rate=0.2, causal=causal))


def std_pair_report(rows, calls):
    """Kernels 9, 10 and 11 at the long step's largest shape at rate 0 too
    (beside the main path's rate: the cost of the dropout hash), and at
    each rate the pair 10 + 11 beside SDPA's backward alone, the one call
    that computes what the pair computes."""
    _, B, H, T, D, kv_lens, r = max((c for c in calls if c[0] == STD[1]),
                                    key=lambda c: (c[1] * c[3] ** 2 * c[4], sum(c[5])))
    for name in STD:
        rows.append(check_std_kernel(name, B, H, T, T, D, torch.bfloat16, seed=T,
                                     label="rate-0", lens=list(kv_lens), rate=0.0))
    fwd = {label: next(x for x in rows if x["name"] == STD[0] and x["label"] == label
                       and x["shape"] == (B, H, T, D) and x["rate"] == rate)
           for label, rate in (("main-path", r), ("rate-0", 0.0))}
    log(f"kernel 9 at B,H,T,D={B},{H},{T},{D} bf16 +lse: rate {r} {fwd['main-path']['ms']:.4f} "
        f"ms, rate 0 {fwd['rate-0']['ms']:.4f} ms (the dropout hash "
        f"{fwd['main-path']['ms'] - fwd['rate-0']['ms']:.4f} ms); SDPA with the mask "
        f"{fwd['main-path']['library_ms']:.4f} ms")
    for label, rate in (("main-path", r), ("rate-0", 0.0)):
        dq, dkv = (next(x for x in rows if x["name"] == n and x["label"] == label
                        and x["shape"] == (B, H, T, D) and x["rate"] == rate) for n in STD[1:])
        log(f"pair 10 + 11 at B,H,T,D={B},{H},{T},{D} bf16 rate {rate}: "
            f"{dq['ms'] + dkv['ms']:.4f} ms (dq {dq['ms']:.4f}, dk/dv {dkv['ms']:.4f}); "
            f"SDPA backward alone {dq['library_bwd_ms']:.4f} ms, SDPA forward + backward "
            f"{dq['library_ms']:.4f} ms; bound {dq['bound_ms'] + dkv['bound_ms']:.4f} ms")


class _KeepOutput:
    """Calls the wrapped AR decoder and keeps its last output."""

    def __init__(self, decode):
        self.decode, self.out = decode, None

    def __call__(self, *args, **kwargs):
        self.out = self.decode(*args, **kwargs)
        return self.out

    def __getattr__(self, name):  # the decoder's other members (expected_steps)
        return getattr(self.decode, name)


def vtn_reference_check(model, vocoder, src, trg):
    """Phase 13: float32 copies of the VTN's weights (prenet dropout 0, the
    flash gate below a 1 s clip's encoder length) and of the vocoder
    convert the clip on the card (kernel 9) and on the CPU (its plain
    version); the decoded features and the waveforms must agree."""
    from seq2seq_vc_torch.models.vtn import VTN
    from seq2seq_vc_torch.pipeline import Wav2WavARConverter

    m32 = VTN(**dict(VTN_CONFIG, flash_min_len=8, **VTN_NO_DROPOUT))
    m32.load_state_dict(model.state_dict())
    v32 = copy.deepcopy(vocoder)
    v32.compute_dtype = torch.float32
    audio = clip(1.0, seed=7)
    feats, wavs, counts = {}, {}, {}
    for dev in ("cuda", "cpu"):
        conv = Wav2WavARConverter(copy.deepcopy(m32).eval(), copy.deepcopy(v32), src, trg,
                                  dict(FEATS, inference=VTN_INFERENCE), device=dev)
        conv.ar_decode = keep = _KeepOutput(conv.ar_decode)
        before = launch_counts()
        wavs[dev] = conv(audio)
        counts[dev] = {k: v - before[k] for k, v in launch_counts().items()}
        feats[dev] = keep.out["outs"][0, :int(keep.out["out_lens"][0])].cpu()
    (fa, fb), (a, b) = (feats["cuda"], feats["cpu"]), (wavs["cuda"], wavs["cpu"])
    same = fa.shape == fb.shape and len(a) == len(b)
    f_err = float((fa - fb).abs().max()) if same else float("inf")
    w_err = float(np.abs(a - b).max()) if same else float("inf")
    want = {n: VTN_CONFIG["elayers"] if n == "flash_attention" else 0 for n in KERNELS}
    ok = (same and f_err <= VTN_REFERENCE_ATOL and w_err <= VTN_REFERENCE_ATOL
          and counts["cuda"] == want and not any(counts["cpu"].values()))
    log(f"VTN reference float32 1.0 s clip: features card {tuple(fa.shape)} cpu "
        f"{tuple(fb.shape)}, max abs diff {f_err:.3e}; waveforms card {len(a)} cpu {len(b)} "
        f"samples, max abs diff {w_err:.3e} (atol {VTN_REFERENCE_ATOL}); launches card "
        f"{counts['cuda']}, cpu {counts['cpu']}: {'ok' if ok else 'FAIL'}")
    return [] if ok else [f"VTN reference check: features {f_err}, waveforms {w_err}, "
                          f"launches {counts}"]


def vtn_serve_path(rows, src, trg):
    """Phases 12-13: VTN serving. Appends the kernel checks to ``rows``;
    returns (failures, launches of the timed requests, by kernel)."""
    from seq2seq_vc_torch.pipeline import Wav2WavARConverter

    failures = []
    with torch.no_grad():
        model, vocoder = vtn_model(seed=20).eval(), build_vocoder(seed=21)
        conv = Wav2WavARConverter(model, vocoder, src, trg, dict(FEATS, inference=VTN_INFERENCE))
        requests = [
            ("VTN single 3.8 s", [clip(3.8, 10)]),
            ("VTN batch of 4", [clip(s, 11 + i) for i, s in enumerate((2.2, 3.0, 3.8, 4.6))]),
            ("VTN single 135 s", [clip(135.0, 16)]),
        ]
        log(f"VTN serving: Wav2WavARConverter, the VTN at full width (float32, attention "
            f"backend flash), decode {VTN_INFERENCE}; warm-up: each request once (the 135 s "
            f"one at maxlenratio {VTN_WARM_MAXLENRATIO}), then the synthesis ladder")
        fails, _ = serve(conv, requests[:-1])
        failures += fails
        conv.ar_decode.maxr = VTN_WARM_MAXLENRATIO
        fails, _ = serve(conv, requests[-1:])
        failures += fails
        conv.ar_decode.maxr = VTN_INFERENCE["maxlenratio"]
        log(f"VTN warm-up synthesis buckets: {conv.warmup_synth()}")
        calls = [vtn_request_calls(conv, clips) for _, clips in requests]
        log(f"VTN encoder flash calls per request (B, H, T, D, key lengths): "
            f"{[[(*c[:4], _short(list(c[4]))) for c in cs] for cs in calls]}")
        if len(calls[-1]) != VTN_CONFIG["elayers"]:
            failures.append(f"vtn_serve: the long request's encoder is not all on flash: {calls[-1]}")
        std_head_dim_checks(rows, ("flash_attention",))
        for B, H, T, D, lens in sorted({c for cs in calls for c in cs}):
            rows.append(check_std_kernel("flash_attention", B, H, T, T, D, torch.float32, seed=T,
                                         label="main-path", lens=list(lens)))

        log("VTN main path: the same requests again")
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        timed, per_request = [], []
        for request in requests:
            before = launch_counts()
            fails, res = serve(conv, [request])
            failures += fails
            timed += res
            per_request.append({k: v - before[k] for k, v in launch_counts().items()})
        launches = launch_counts()
        log(f"VTN main path launches {launches}; kernel 9 per request "
            f"{[c['flash_attention'] for c in per_request]}, expected from the routing "
            f"{[len(cs) for cs in calls]}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for (label, _), got, cs in zip(requests, per_request, calls):
            want = {n: len(cs) if n == "flash_attention" else 0 for n in KERNELS}
            if got != want:
                failures.append(f"vtn_serve {label}: launches {got}, expected {want}")
        profile_request(conv, requests[-1], timed[-1]["ms"], port_kernels=("flash_fwd_kernel",))
        failures += vtn_reference_check(model, vocoder, src, trg)
    return failures, launches


def make_vtn_trainer(state, loader, steps: int, device=None):
    """An ``ARVCTrainer`` with the YAML's Seq2SeqLoss that takes ``steps``
    more optimizer steps on ``state``."""
    from seq2seq_vc_torch.losses import get_criterion
    from seq2seq_vc_torch.train.ar_vc import ARVCTrainer

    config = dict(VTN_TRAIN_CONFIG, train_max_steps=state.steps + steps)
    criterion = {"Seq2SeqLoss": get_criterion("Seq2SeqLoss", bce_pos_weight=VTN_BCE_POS_WEIGHT)}
    return ARVCTrainer(state, criterion, config, loader, device=device or DEVICE)


def vtn_long_lens(seed: int):
    """BATCH (source, target) frame counts over VTN_LONG (131-147 s of 16
    kHz audio at hop 256): targets spread evenly, sources the same lengths
    shuffled, so that after the x4 subsampling every encoder key length
    lies in FLASH_MIN_LEN .. FLASH_MIN_LEN + 256."""
    trg = np.linspace(*VTN_LONG, BATCH).round().astype(int)
    src = np.random.default_rng(seed).permutation(trg)
    return list(zip(src.tolist(), trg.tolist()))


def vtn_train_path(rows, path: str):
    """Phase 14 (``path`` "vtn_train": B 16 at 160-512 frames, all on the
    dense route) or 15 ("vtn_train_long": B 16 at VTN_LONG frames, the
    encoder on kernels 9-11): a warm-up step, the kernel checks, 3 timed
    steps and a profile of one. Appends the kernel checks to ``rows``;
    returns (failures, launches of the timed steps, by kernel)."""
    from seq2seq_vc_torch.train.data import ARVCCollater

    failures = []
    tmp = REPO / "build"
    tmp.mkdir(exist_ok=True)
    lens = corpus_lens(160, 512, seed=30) if path == "vtn_train" else vtn_long_lens(seed=31)
    collater = ARVCCollater(PAD_MULTIPLE, VTN_CONFIG["decoder_reduction_factor"])
    with tempfile.TemporaryDirectory(dir=tmp, prefix=f"chip_smoke_{path}_") as root:
        loader = corpus_loader(Path(root), lens, seed=32, collater=collater)
        batch = next(iter(loader))
        state = train_state(vtn_model(seed=33, compute_dtype="bfloat16").train().to(DEVICE))
        label = f"VTN T{batch['xs'].shape[1]}/{batch['ys'].shape[1]}"
        log(f"{path}: ARVCTrainer, the VTN at full width (bf16, dropout 0.1, prenet 0.5), "
            f"B{BATCH}; sources {sorted(batch['ilens'].tolist())}, targets "
            f"{sorted(batch['olens'].tolist())} frames, padded (xs, ys) {batch['xs'].shape}, "
            f"{batch['ys'].shape}")
        train_steps(state, loader, 1, f"{label} warm-up", make=make_vtn_trainer)

        rate = state.model.encoder.encoders[0].self_attn.dropout_rate
        calls = [(name, *c, rate) for c in vtn_encoder_calls(state.model, batch["xs"].shape[1],
                                                              batch["ilens"].tolist())
                 for name in STD]
        if path == "vtn_train_long":
            std_head_dim_checks(rows, STD[1:])
        for name, B, H, T, D, kv_lens, r in sorted(set(calls)):
            rows.append(check_std_kernel(name, B, H, T, T, D, torch.bfloat16, seed=T,
                                         label="main-path", lens=list(kv_lens), rate=r))
        if path == "vtn_train_long":
            std_pair_report(rows, calls)

        log(f"{path} main path: 3 steps at {label}")
        notes, handle, n_att = watch_grads(state)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        trainer = train_steps(state, loader, 3, label, make=make_vtn_trainer)
        launches = launch_counts()
        handle.remove()
        expected = {n: 3 * sum(c[0] == n for c in calls) for n in KERNELS}
        step_ms = [h["train/step_time_sec"] * 1e3 for h in trainer.history]
        log(f"{path}: ms/step {[round(x, 1) for x in step_ms]} (mean {np.mean(step_ms):.1f}); "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"launches {launches}, expected from the routing {expected}")
        for name in KERNELS:
            want = expected[name]
            if launches[name] != want or (launches[name] == 0 and name in PATH_KERNELS[path]):
                failures.append(f"{path} {name}: {launches[name]} launches, expected {want}")
        if path == "vtn_train_long" and any(expected[n] != 3 * VTN_CONFIG["elayers"] for n in STD):
            failures.append(f"{path}: the routing does not put every encoder layer on flash")
        losses = [h["train/loss"] for h in trainer.history]
        if not all(math.isfinite(x) for x in losses):
            failures.append(f"{path}: loss not finite: {losses}")
        finite = [bool(f) for f, _ in notes]
        att_min = [float(m) for _, m in notes]
        log(f"{path} gradients per step: all finite {finite}; smallest norm among the "
            f"{n_att} self-attention projections' weight gradients {att_min}")
        if len(notes) != 3 or not all(finite) or not all(m > 0 for m in att_min):
            failures.append(f"{path}: gradients finite {finite}, attention grad norms {att_min}")
        profile_step(state, loader, float(np.mean(step_ms)), f"B{BATCH}, {label}",
                     port_kernels=("flash_fwd_kernel", "flash_bwd_dq_kernel",
                                   "flash_bwd_dkv_kernel"), make=make_vtn_trainer)
        del state, trainer
    return failures, launches


def vtn_reference_step(seed: int):
    """Phase 16: one float32 VTN training step's loss and gradients from
    the same weights and batch (B 2, 100-128 frames), dropout off and the
    flash gate below the encoder's key length, on the card (kernels 9, 10
    and 11) and on the CPU (their plain versions), to phase 9's tolerances."""
    model = vtn_model(seed, flash_min_len=16, **VTN_NO_DROPOUT).train()
    model.postnet.dropout_rate = 0.0
    want = {n: VTN_CONFIG["elayers"] if n in STD else 0 for n in KERNELS}
    return ar_reference_step(
        model, lambda m, dev: make_vtn_trainer(train_state(m), [], 1, device=dev), seed, want,
        "VTN reference step", "flash route")


def ar_reference_step(model, make, seed: int, want, label: str, route: str):
    """One float32 training step of an AR model (the trainer ``make(model,
    device)`` builds) from the same weights and batch (B 2, 100-128
    frames), on the card and on the CPU: the loss, its terms and every
    gradient must agree to phase 9's tolerances (a parameter without a
    gradient, frozen, must have none on both sides); the card's launches
    must be ``want``, the CPU's none."""
    from seq2seq_vc_torch.train.data import ARVCCollater

    collater = ARVCCollater(PAD_MULTIPLE, model.decoder_reduction_factor)
    batch = collater(feature_items([(128, 128), (100, 112)], seed))
    runs = {}
    for side, dev in (("card", DEVICE), ("cpu", "cpu")):
        trainer = make(copy.deepcopy(model), dev)
        pre = {}  # the ReLUs' inputs
        for name, mod in trainer.model.named_modules():
            if name.endswith(VTN_RELU_INPUTS):
                mod.register_forward_hook(
                    lambda mod, args, out, name=name: pre.__setitem__(name, out.detach().cpu()))
        before = launch_counts()
        loss, metrics = trainer.loss_fn(trainer._array_batch(batch), trainer._flags(),
                                        trainer.generator)
        loss.backward()
        grads = {n: p.grad.detach().float().cpu() for n, p in trainer.model.named_parameters()
                 if p.grad is not None}
        trainable = {n for n, p in trainer.model.named_parameters() if p.requires_grad}
        counts = {k: v - before[k] for k, v in launch_counts().items()}
        runs[side] = (loss.item(), {k: v.item() for k, v in metrics.items()}, grads, counts, pre,
                      trainable)
    (la, ma, ga, ca, pa, ta), (lb, mb, gb, cb, pb, tb) = runs["card"], runs["cpu"]
    flips = {n: [float(x) for x in pb[n][(pa[n] > 0) != (pb[n] > 0)]] for n in pb}
    flips = {n: xs for n, xs in flips.items() if xs}
    failures = [f"{label} {name}: card {a} cpu {b}"
                for name, a, b in [("loss", la, lb)] + [(k, ma[k], mb[k]) for k in mb]
                if not (math.isfinite(a) and abs(a - b) <= STEP_RTOL * abs(b))]
    if set(ga) != ta or set(gb) != tb:
        failures.append(f"{label}: gradients of {sorted(set(ga) ^ ta)} (card), "
                        f"{sorted(set(gb) ^ tb)} (cpu) against the trainable parameters")
    if set(ga) != set(gb):
        failures.append(f"{label}: gradients of {sorted(set(ga) ^ set(gb))} on one side")
    top = max(float(g.abs().max()) for g in gb.values())
    worst = (0.0, "")
    for name in sorted(set(ga) & set(gb)):
        a, b = ga[name], gb[name]
        if name.endswith("linear_k.bias"):  # rounding noise on both devices
            if max(float(a.abs().max()), float(b.abs().max())) > NOISE_RTOL * top:
                failures.append(f"{label} {name}: not rounding noise")
            continue
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        # a tensor whose own output fed a ReLU input that flipped: FLIP_RTOL
        flipped = name.rpartition(".")[0] in flips
        worst = max(worst, (rel, name)) if not flipped else worst
        if not (torch.isfinite(a).all() and rel <= (FLIP_RTOL if flipped else GRAD_RTOL)):
            failures.append(f"{label} {name}: gradient error {rel:.3e} of its largest")
    if ca != want or any(cb.values()):
        failures.append(f"{label} launches: card {ca}, cpu {cb}")
    flip_errs = {n: float((ga[n + ".weight"] - gb[n + ".weight"]).abs().max()
                          / gb[n + ".weight"].abs().max()) for n in flips if n + ".weight" in gb}
    n_params = sum(1 for _ in model.parameters())
    log(f"{label}: float32 train step, {route} (B 2, 100-128 frames, dropout off): "
        f"loss card {la:.6f} cpu {lb:.6f}; terms card {ma} cpu {mb}; {len(gb)} gradient "
        f"tensors, one for each of the {len(tb)} trainable of {n_params} parameters, worst error of a tensor's largest {worst[0]:.3e} "
        f"({worst[1]}; rtol {GRAD_RTOL}); ReLU inputs on opposite sides of 0 (cpu values) "
        f"{flips}, their modules' weight gradient errors {flip_errs} (rtol {FLIP_RTOL}); "
        f"launches card {ca}, cpu {cb}: {'ok' if not failures else 'FAIL'}")
    return failures


# ------------------------------------------- legacy relative positions
def legacy_serve_path(rows, src, trg):
    """Phases 17-18: the flagship with legacy relative positions serves the
    same three requests. Below the flash gate the legacy attention takes the
    dense ops (it never takes the fused kernel), so kernel 2's legacy form
    must launch exactly in the 30 s request's decoder. Then a float32
    conversion card vs CPU with the decoder's gate lowered. Appends the
    kernel checks to ``rows``; returns (failures, launches of the timed
    requests, by kernel)."""
    from seq2seq_vc_torch.pipeline import Wav2WavConverter

    failures = []
    with torch.no_grad():
        model, vocoder = build_models(seed=40, **LEGACY_CONFIG)
        conv = Wav2WavConverter(model, vocoder, src, trg, FEATS)
        requests = serving_requests()
        log("legacy serving: Wav2WavConverter, the flagship with conformer_rel_pos_type "
            "legacy at full width (bf16, attention backend flash); warm-up: each request once, "
            "then the synthesis ladder")
        fails, warm = serve(conv, requests)
        failures += fails
        log(f"legacy warm-up synthesis buckets: {conv.warmup_synth()}")
        calls = [planned_calls(conv, [r], [w["out_frames"]]) for r, w in zip(requests, warm)]
        log(f"legacy kernel calls per request (name, B, H, T, D, key lengths): {calls}")
        if [len(cs) for cs in calls] != [0, 0, FLAGSHIP["dlayers"]] or any(
                c[0] != LEGACY[0] or c[4] != FLAGSHIP["adim"] * 4 // FLAGSHIP["aheads"]
                for c in calls[-1]):
            failures.append(f"legacy_serve: the routing does not put exactly the 30 s "
                            f"request's decoder on kernel 2's legacy form: {calls}")
        for D, T in ((192, 640), (768, 1300)):
            for dtype in (torch.float32, torch.bfloat16):
                rows.append(check_kernel(LEGACY[0], 2, 2, T, D, dtype, seed=T + D,
                                         label="head-dim", lens=[T, 2 * T // 3]))
        for B, H, T, D, lens in sorted({c[1:] for cs in calls for c in cs}):
            rows.append(check_kernel(LEGACY[0], B, H, T, D, torch.bfloat16, seed=T,
                                     label="main-path", lens=lens))

        log("legacy serving main path: the same requests again")
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        per_request = []
        for request in requests:
            before = launch_counts()
            fails, _ = serve(conv, [request])
            failures += fails
            per_request.append({k: v - before[k] for k, v in launch_counts().items()})
        launches = launch_counts()
        log(f"legacy serving launches {launches}; kernel 2's legacy form per request "
            f"{[c[LEGACY[0]] for c in per_request]}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for (label, _), got, cs in zip(requests, per_request, calls):
            want = {n: sum(c[0] == n for c in cs) for n in KERNELS}
            if got != want:
                failures.append(f"legacy_serve {label}: launches {got}, expected {want}")
        failures += reference_check(model, vocoder, src, trg, "legacy_serve", **LEGACY_CONFIG)
    return failures, launches


def train_pallas_path(rows):
    """Phase 21: the fused route's backward through kernels 4 and 5. An
    ``AASVCTrainer`` on the full-width flagship with ``rel_scores_bwd:
    pallas`` takes one warm-up step and 2 timed steps at B 16 on 480-960
    frames: one launch of each of kernels 4 and 5 per fused-route layer
    backward, none of kernel 3. Kernels 4 and 5 against their plain
    versions at the fused route's training shapes (T 512 and 960, D 192 and
    768) in float32 and bfloat16, and at the steps' shapes. Appends the
    kernel checks to ``rows``; returns (failures, launches of the timed
    steps, by kernel)."""
    failures = []
    tmp = REPO / "build"
    tmp.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=tmp, prefix="chip_smoke_pallas_") as root:
        loader = corpus_loader(Path(root), corpus_lens(480, 960, seed=960), seed=960)
        batch = next(iter(loader))
        state = train_state(flagship(seed=47, rel_scores_bwd="pallas").to(DEVICE))
        label = f"T{batch['xs'].shape[1]}/{batch['ys'].shape[1]}"
        log(f"train_pallas: AASVCTrainer, flagship at full width (bf16, dropout 0.2, "
            f"rel_scores_bwd pallas), B{BATCH}, padded (xs, ys) {batch['xs'].shape}, "
            f"{batch['ys'].shape}; warm-up: one step")
        train_steps(state, loader, 1, "pallas warm-up")

        calls = train_calls(state.model, batch)
        for T in (512, 960):
            for D in (192, 768):
                for dtype in (torch.float32, torch.bfloat16):
                    for name in PAIR:
                        rows.append(check_kernel(name, BATCH, 2, T, D, dtype, seed=T + D,
                                                 label="head-dim"))
        for name, B, H, T, D, lens in sorted({c for c in calls if c[0] in PAIR}):
            rows.append(check_kernel(name, B, H, T, D, torch.bfloat16, seed=T + D + 1,
                                     label="main-path", lens=list(lens)))

        log(f"train_pallas main path: 2 steps at {label}")
        notes, handle, n_att = watch_grads(state)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        trainer = train_steps(state, loader, 2, label)
        launches = launch_counts()
        handle.remove()
        expected = {n: 2 * sum(c[0] == n for c in calls) for n in KERNELS}
        step_ms = [h["train/step_time_sec"] * 1e3 for h in trainer.history]
        log(f"train_pallas: ms/step {[round(x, 1) for x in step_ms]} (mean "
            f"{np.mean(step_ms):.1f}); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}, "
            f"expected from the routing {expected}")
        for name in KERNELS:
            want = expected[name]
            if launches[name] != want or (launches[name] == 0 and name in PATH_KERNELS["train_pallas"]):
                failures.append(f"train_pallas {name}: {launches[name]} launches, expected {want}")
        if any(expected[n] != 2 * 8 for n in PATH_KERNELS["train_pallas"]) or launches["rel_band_bwd"]:
            failures.append(f"train_pallas: not every layer's backward on kernels 4-5: {expected}")
        losses = [h["train/loss"] for h in trainer.history]
        finite = [bool(f) for f, _ in notes]
        att_min = [float(m) for _, m in notes]
        log(f"train_pallas gradients per step: all finite {finite}; smallest norm among the "
            f"{n_att} attention projections' weight gradients {att_min}")
        if not all(math.isfinite(x) for x in losses):
            failures.append(f"train_pallas: loss not finite: {losses}")
        if len(notes) != 2 or not all(finite) or not all(m > 0 for m in att_min):
            failures.append(f"train_pallas: gradients finite {finite}, attention grad norms {att_min}")
        del state, trainer
    return failures, launches


def bwd_sweep() -> int:
    """The rel-scores backward's three variants (dq_v and dpos), timed at
    the training step's batch (B 16, H 2) in bf16 over key lengths T at the
    encoder's and the decoder's head dims: ``banded`` (kernel 3), ``pallas``
    (kernels 4 + 5) and ``xla``. The data for ``AUTO_BANDED_MIN_LEN``. Each
    D's first length is timed twice and its first reading dropped (it
    carries the shape's warm-up); below T 128 the launches are short
    enough that the times are mostly the host's launch path."""
    from seq2seq_vc_torch.ops.rel_scores import (rel_band_bwd, rel_band_bwd_dpos,
                                                 rel_band_bwd_dqv, rel_band_bwd_xla)

    log(f"card: {card_line()}")
    lengths = (1, 2, 4, 8, 16, 32, 64, 96, 128, 256, 384, 512, 640, 768, 896, 960, 1280,
               1664, 2048)
    for D in (192, 768):
        for n, T in enumerate((lengths[0],) + lengths):
            qu, qv, _, _, pos, _ = kernel_inputs(16, 2, T, D, torch.bfloat16, seed=T)
            g = torch.randn(16, 2, T, T, device="cuda")
            ms = {"banded": cuda_ms(lambda: rel_band_bwd(g, qv, pos)),
                  "pallas": cuda_ms(lambda: (rel_band_bwd_dqv(g, qv, pos),
                                             rel_band_bwd_dpos(g, qv, pos))),
                  "xla": cuda_ms(lambda: rel_band_bwd_xla(g, qv, pos))}
            log(f"bwd sweep B16 H2 T{T} D{D} bf16{' (warm-up)' if n == 0 else ''}: "
                + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
                + f"; {min(ms, key=ms.get)} fastest")
            del qu, qv, pos, g
    return 0


def sweep_layer(route: str, T: int, D: int, seed: int):
    """One conformer self-attention layer of the flagship (2 heads of D,
    bf16 compute, attention dropout 0.2) in train() mode, routed to
    ``route``, with a B 16 batch of key lengths spread over [T/2, T]:
    returns (module, inputs, output cotangent)."""
    from seq2seq_vc_torch.nn.attention import RelPositionMultiHeadedAttention
    from seq2seq_vc_torch.nn.positional_encoding import relative_pe

    torch.manual_seed(seed)
    n_feat, B = 2 * D, 16
    att = RelPositionMultiHeadedAttention(
        2, n_feat, dropout_rate=0.2, backend=route, flash_min_len=0,
        compute_dtype=torch.bfloat16, rel_scores_bwd="auto", device="cuda").train()
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, T, n_feat, device="cuda", generator=g).requires_grad_()
    pos = relative_pe(T, n_feat).to("cuda")[None]
    lens = torch.linspace(T // 2, T, B, device="cuda").long()
    mask = (torch.arange(T, device="cuda")[None, :] < lens[:, None])[:, None, :]
    assert att.route(T, T, 2 * T - 1, mask) == route
    dy = torch.randn(B, T, n_feat, device="cuda", generator=g)
    return att, (x, x, x, pos, mask), dy


def sweep_std_layer(route: str, T: int, seed: int):
    """One VTN encoder self-attention layer (4 heads of D 96, bf16 compute,
    attention dropout 0.1) in train() mode on the dense (``"xla"``) or the
    flash route, with a B 16 batch of key lengths spread over [T/2, T]:
    returns (module, inputs, output cotangent)."""
    from seq2seq_vc_torch.nn.attention import MultiHeadedAttention

    torch.manual_seed(seed)
    n_feat, B = 384, 16
    att = MultiHeadedAttention(4, n_feat, dropout_rate=0.1, backend=route, flash_min_len=0,
                               compute_dtype=torch.bfloat16, device="cuda").train()
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, T, n_feat, device="cuda", generator=g).requires_grad_()
    lens = torch.linspace(T // 2, T, B, device="cuda").long()
    mask = (torch.arange(T, device="cuda")[None, :] < lens[:, None])[:, None, :]
    assert att.route(T, mask) == route
    dy = torch.randn(B, T, n_feat, device="cuda", generator=g)
    return att, (x, x, x, mask), dy


def sweep_point(att, inputs, dy):
    """(ms, GiB) of one layer's forward + backward: CUDA-event time and the
    peak device memory above what the inputs hold."""
    def step():
        att(*inputs).backward(dy)

    step()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    return cuda_ms(step, min_total_ms=300, max_iters=10), peak


def flash_sweep() -> int:
    """One attention layer's forward + backward in bf16 over key lengths
    T, through each module's routes: the rel-pos layer (B 16, H 2, dropout
    0.2) through the fused and the flash route at the AAS-VC encoder's and
    decoder's head dims, and the standard layer (B 16, H 4, D 96, dropout
    0.1: the VTN encoder's) through the dense and the flash route. Each
    one's ms and peak memory: the data for ``FLASH_MIN_LEN``."""
    log(f"card: {card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    points = [(f"B16 H2 T{T} D{D}", ("fused", "flash"),
               lambda route, T=T, D=D: sweep_layer(route, T, D, seed=T + D))
              for D in (192, 768) for T in (1024, 1536, 2048, 2560, 3072, 4096)]
    points += [(f"standard B16 H4 T{T} D96", ("xla", "flash"),
                lambda route, T=T: sweep_std_layer(route, T, seed=T))
               for T in (1024, 1536, 2048, 2560, 3072, 4096)]
    for what, routes, layer in points:
        res = {}
        for route in routes:
            res[route] = sweep_point(*layer(route))
            torch.cuda.empty_cache()
        (a_ms, a_gib), (f_ms, f_gib) = (res[r] for r in routes)
        log(f"flash sweep {what} bf16 fwd+bwd: {routes[0]} {a_ms:.3f} ms {a_gib:.3f} GiB, "
            f"flash {f_ms:.3f} ms {f_gib:.3f} GiB; "
            f"{'flash' if f_ms < a_ms else routes[0]} faster")
    return 0


# --------------------------------------------------------------- the CLIs
CLI_CONF = REPO / "egs/arctic/vc2/conf/aas_vc.melmelmel.v1.yaml"
CLI_VTN_CONF = REPO / "egs/arctic/vc1/conf/vtn.v1.yaml"
CLI_SECONDS = (2.0, 5.0)  # the corpus's source utterances spread over this range
CLI_DEV = 4  # dev utterances (what vc_decode decodes); the train set is one batch
# vc_decode's features of one utterance against AASVC.inference called
# directly on the same card, weights, padded input and generator: the same
# computation, so any difference beyond rounding noise is a fault
CLI_DECODE_ATOL = 1e-4


def cli_corpus(root: Path):
    """A parallel corpus as a recipe's stages 0-2 leave it, built with the
    port's own modules: synthetic wavs (the target speaker 10% slower)
    written and read back by ``utils/audio.py``, log-mels from
    ``dsp/features.logmelfilterbank`` on the card, each speaker's stats from
    its train set (``.npz``), features normalised and written as ``.npy`` with
    a ``feats.scp`` per speaker and subset. Returns the paths by name."""
    from seq2seq_vc_torch.dsp.features import logmelfilterbank
    from seq2seq_vc_torch.dsp.stats import normalize
    from seq2seq_vc_torch.utils.audio import read_wav, write_wav
    from seq2seq_vc_torch.utils.io import write_stats

    sr = FEATS["sampling_rate"]
    mel_kw = {k: v for k, v in FEATS.items() if k != "sampling_rate"}
    secs = np.linspace(*CLI_SECONDS, BATCH + CLI_DEV)
    paths = {}
    for spk, stretch, seed in (("src", 1.0, 100), ("trg", 1.1, 200)):
        feats = {}
        for i, s in enumerate(secs):
            utt = f"{'train' if i < BATCH else 'dev'}{i:02d}"
            wav = root / f"{spk}_{utt}.wav"
            write_wav(str(wav), clip(s * stretch, seed + i), sr)
            feats[utt] = logmelfilterbank(read_wav(str(wav))[0], sr, device="cuda", **mel_kw)
        train = np.concatenate([f for u, f in feats.items() if u.startswith("train")])
        mean, scale = train.mean(0), train.std(0)
        paths[f"{spk}_stats"] = str(root / f"{spk}_stats.npz")
        write_stats(paths[f"{spk}_stats"], mean, scale, "mel")
        for subset in ("train", "dev"):
            lines = []
            for utt, f in feats.items():
                if utt.startswith(subset):
                    np.save(root / f"{spk}_{utt}.npy", normalize(f, mean, scale).astype(np.float32))
                    lines.append(f"{utt} {root / f'{spk}_{utt}.npy'}")
            paths[f"{spk}_{subset}"] = str(root / f"{spk}_{subset}.scp")
            Path(paths[f"{spk}_{subset}"]).write_text("\n".join(lines) + "\n")
    return paths


def cli_launches(path, failures):
    """The launch counts since the last reset; a kernel of ``path`` that did
    not launch, or another kernel that did, is a failure."""
    torch.cuda.synchronize()
    counts = launch_counts()
    for name, n in counts.items():
        if (n == 0) == (name in PATH_KERNELS[path]):
            failures.append(f"{path} {name}: {n} launches")
    log(f"{path} launches {counts}")
    return counts


def cli_path(rows):
    """Phase 22: the command-line entry points, driven in-process through
    their ``main(argv)``: ``vc_train`` on the flagship's shipped conf at full
    width (B 16) for 3 steps with an evaluation (and ``generate_intermediate``)
    and a checkpoint at step 2, then ``--resume`` to step 4; ``vc_decode`` of
    the dev set with a ``vocoder:`` block naming a seeded HiFi-GAN the phase
    saved (batch size 1 twice, then 4), one utterance held against
    ``AASVC.inference``; ``vc_serve`` over stdio with 3 requests, the last
    long enough that the encoder's keys reach the flash gate; ``vc_train``
    (2 steps) and ``vc_decode`` (2 utterances, Griffin-Lim) on the VTN's
    shipped conf. Kernels 1 and 3 must launch in ``vc_train``, 1 and 2 in
    ``vc_serve``; each kernel is checked at the shapes each CLI gave it
    (``vc_decode``'s from its batches and the output lengths it wrote)."""
    import argparse
    import contextlib
    import io

    import yaml

    from seq2seq_vc_torch.bin import vc_decode, vc_serve, vc_train
    from seq2seq_vc_torch.core.config import load_config
    from seq2seq_vc_torch.nn.attention import FLASH_MIN_LEN
    from seq2seq_vc_torch.train.data import (DataLoader, ParallelVCMelDataset,
                                             SourceVCMelDataset, pad_batch)
    from seq2seq_vc_torch.utils.audio import write_wav

    failures, launches = [], {}
    card = card_line()
    sr, hop = FEATS["sampling_rate"], FEATS["hop_size"]
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="chip_smoke_cli_") as tmp:
        root = Path(tmp)
        c = cli_corpus(root)
        torch.save(build_vocoder(seed=41).state_dict(), root / "hifigan.pt")
        gen = {k: [list(x) if isinstance(x, tuple) else x for x in v] if isinstance(v, tuple)
               else v for k, v in HIFIGAN.items()}
        (root / "hifigan.yaml").write_text(yaml.safe_dump(
            {"generator_type": "HifiganGenerator", "generator_params": gen}))
        vocoder = {"checkpoint": str(root / "hifigan.pt"), "config": str(root / "hifigan.yaml")}

        def overlay(name, **keys):
            (root / name).write_text(yaml.safe_dump(keys))
            return ["--additional-config", str(root / name)]

        data = ["--src-train-dumpdir", c["src_train"], "--src-dev-dumpdir", c["src_dev"],
                "--trg-train-dumpdir", c["trg_train"], "--trg-dev-dumpdir", c["trg_dev"],
                "--trg-stats", c["trg_stats"]]
        every = dict(eval_interval_steps=2, save_interval_steps=2, log_interval_steps=1)
        exp = root / "exp"
        aas = data + ["--train-dp-input-dir", c["src_train"], "--dev-dp-input-dir", c["src_dev"],
                      "--config", str(CLI_CONF), "--outdir", str(exp)]
        log(f"cli: vc_train on {CLI_CONF.relative_to(REPO)}, {BATCH} train and {CLI_DEV} dev "
            f"utterances of {CLI_SECONDS[0]}-{CLI_SECONDS[1]} s; 3 steps, then --resume to 4")
        reset_launch_counts()
        first = vc_train.main(aas + overlay("steps3.yaml", train_max_steps=3, **every))
        resumed = vc_train.main(aas + overlay("steps4.yaml", train_max_steps=4, **every)
                                + ["--resume", str(exp / "checkpoint-3steps.pt")])
        launches["cli_train"] = cli_launches("cli_train", failures)
        history = [h for t in (first, resumed) for h in t.history if "train/loss" in h]
        for h in history:
            log(f"cli vc_train step {h['steps']}: {h['train/step_time_sec'] * 1e3:.1f} ms, "
                f"loss {h['train/loss']:.4f}")
        # step 1's interval holds the warm-up, step 3's step 2's evaluation,
        # generate_intermediate and checkpoint, step 4's the resumed
        # process's first step: step 2 is the one plain step
        log(f"cli vc_train: {history[1]['train/step_time_sec'] * 1e3:.1f} ms a step (step 2, "
            f"B {BATCH}); card {card}")
        made = [exp / n for n in ("config.yml", "checkpoint-2steps.pt", "checkpoint-3steps.pt",
                                  "checkpoint-4steps.pt")]
        preds = [len(list((exp / "predictions" / f"{n}steps").glob("*.npy"))) for n in (2, 4)]
        cfg = load_config(str(exp / "config.yml"))
        n_preds = min(cfg["num_save_intermediate_results"], CLI_DEV)
        if ([h["steps"] for h in history] != [1, 2, 3, 4] or resumed.steps != 4
                or not all(math.isfinite(h["train/loss"]) for h in history)
                or not all(p.exists() for p in made) or preds != [n_preds, n_preds]):
            failures.append(f"cli vc_train: steps {[h['steps'] for h in history]}, files "
                            f"{[p.exists() for p in made]}, predictions {preds}")
        train_set = ParallelVCMelDataset(c["src_train"], c["trg_train"], dp_feats=c["src_train"])
        batch = next(iter(DataLoader(train_set, vc_train.build_collater(cfg), BATCH, prefetch=0)))
        for name, B, H, T, D, lens in sorted(set(train_calls(resumed.model, batch))):
            rows.append(check_kernel(name, B, H, T, D, torch.bfloat16, seed=T + D, label="cli",
                                     lens=list(lens)))
        del first, resumed

        ckpt = str(exp / "checkpoint-4steps.pt")
        (root / "decode.yml").write_text(yaml.safe_dump(dict(cfg, vocoder=vocoder)))
        # what a length the process has not decoded costs: train utterances
        # 0, 4, 8, 12 (lengths and buckets new to vc_decode), then 1, 5, 9,
        # 13 (new lengths in the buckets just met)
        train_lines = Path(c["src_train"]).read_text().splitlines()
        fresh = [root / "src_new_buckets.scp", root / "src_seen_buckets.scp"]
        for k, path in enumerate(fresh):
            path.write_text("\n".join(train_lines[k::4]) + "\n")
        decodes = (("first pass", c["src_dev"], 1, "dec1"),
                   ("same lengths again", c["src_dev"], 1, "dec1b"),
                   ("new lengths, new buckets", str(fresh[0]), 1, "dec_new"),
                   ("new lengths, seen buckets", str(fresh[1]), 1, "dec_seen"),
                   ("batched", c["src_dev"], 4, "dec4"))
        reset_launch_counts()
        for label, scp, bs, out in decodes:
            r = vc_decode.main(["--dumpdir", scp, "--dp-input-dir", scp, "--checkpoint", ckpt,
                                "--config", str(root / "decode.yml"), "--outdir", str(root / out),
                                "--batch-size", str(bs)])
            n_utts = len(Path(scp).read_text().splitlines())
            log(f"cli vc_decode {label} (batch size {bs}): {n_utts} utterances, {r['frames']} mel "
                f"frames in {r['seconds'] * 1e3:.1f} ms ({r['seconds'] * 1e3 / n_utts:.1f} ms an "
                f"utterance), {r['frames_per_sec']:.1f} mel-frames/s; card {card}")
            wavs = list((root / out / "wav").glob("*.wav"))
            if len(wavs) != n_utts or r["frames"] <= 0:
                failures.append(f"cli vc_decode {label}: {len(wavs)} wavs, {r['frames']} frames")
        launches["cli_decode"] = cli_launches("cli_decode", failures)
        model = vc_decode.load_model(cfg, ckpt, "cuda")
        for name, B, H, T, D, lens in sorted({call for _, scp, bs, out in decodes
                                              for call in decode_calls(model, scp, bs,
                                                                       root / out)}):
            rows.append(check_kernel(name, B, H, T, D, torch.bfloat16, seed=T + D, label="cli",
                                     lens=list(lens)))
        item = SourceVCMelDataset(c["src_dev"], dp_feats=c["src_dev"])[0]
        xs, dp = (torch.as_tensor(pad_batch([item[k]], vc_decode.frame_multiple(model)),
                                  device="cuda") for k in ("src_feat", "dp_input"))
        out = model.inference(xs, torch.tensor([len(item["src_feat"])], device="cuda"), dp,
                              max_output_frames=2 * xs.shape[1],
                              generator=vc_decode.utterance_generator(cfg.get("seed", 0), 0))
        want = out["outs"][0, : int(out["out_lens"][0])].float().cpu().numpy()
        got = np.load(root / "dec1" / f"{item['utt_id']}.npy")
        err = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
        ok = err <= CLI_DECODE_ATOL
        log(f"cli vc_decode {item['utt_id']} vs AASVC.inference on the same weights, input and "
            f"generator: shapes {got.shape} {want.shape}, max abs diff {err:.3e} "
            f"(atol {CLI_DECODE_ATOL}): {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"cli vc_decode vs AASVC.inference: diff {err}")
        del model

        # the long request: at least FLASH_MIN_LEN encoder frames (hop, and
        # the encoder's frame stacking, from the conf)
        long_s = FLASH_MIN_LEN * hop * cfg["model_params"]["encoder_reduction_factor"] / sr + 0.5
        clips = [(f"{s:.1f} s", clip(s, 60 + i)) for i, s in enumerate((3.8, 2.2, long_s))]
        lines = []
        for i, (_, audio) in enumerate(clips):
            write_wav(str(root / f"req{i}.wav"), audio, sr)
            lines.append(f"{root / f'req{i}.wav'} {root / f'res{i}.wav'}")
        serve = dict(checkpoint=ckpt, config=None, src_stats=c["src_stats"],
                     trg_stats=c["trg_stats"], vocoder_checkpoint=vocoder["checkpoint"],
                     vocoder_config=vocoder["config"], vocoder_stats=None, feat_type="mel",
                     bucket_frames=128, device=None)
        argv = [a for k, v in serve.items() if v is not None
                for a in (f"--{k.replace('_', '-')}", str(v))]
        reset_launch_counts()
        stdin, sys.stdin = sys.stdin, io.StringIO("\n".join(lines) + "\n")
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                vc_serve.main(argv)
        finally:
            sys.stdin = stdin
        launches["cli_serve"] = cli_launches("cli_serve", failures)
        results = [json.loads(x) for x in buf.getvalue().splitlines()]
        if results[:1] != [{"ready": True}] or len(results) != 1 + len(clips) \
                or not all(r.get("ok") for r in results[1:]):
            failures.append(f"cli vc_serve: {results}")
        for (label, _), r in zip(clips, results[1:]):
            log(f"cli vc_serve request {label}: wall {r.get('wall_ms')} ms, RTF {r.get('rtf')}, "
                f"output {r.get('output_seconds')} s; card {card}")
        conv = vc_serve.build_converter(argparse.Namespace(**serve))
        out_frames = [[round(r["output_seconds"] * sr / hop)] for r in results[1:]]
        for name, B, H, T, D, lens in sorted(set(planned_calls(
                conv, [(label, [a]) for label, a in clips], out_frames))):
            rows.append(check_kernel(name, B, H, T, D, torch.bfloat16, seed=T + D, label="cli",
                                     lens=list(lens)))
        del conv

        exp_vtn = root / "exp_vtn"
        log(f"cli: vc_train on {CLI_VTN_CONF.relative_to(REPO)} for 2 steps, then vc_decode of 2 "
            f"utterances (no vocoder block: Griffin-Lim)")
        reset_launch_counts()
        vtn = vc_train.main(data + ["--config", str(CLI_VTN_CONF), "--outdir", str(exp_vtn)]
                            + overlay("vtn.yaml", train_max_steps=2, **every))
        two = root / "src_two.scp"
        two.write_text("\n".join(Path(c["src_dev"]).read_text().splitlines()[:2]) + "\n")
        r = vc_decode.main(["--dumpdir", str(two), "--checkpoint",
                            str(exp_vtn / "checkpoint-2steps.pt"), "--outdir",
                            str(root / "dec_vtn"), "--batch-size", "2"])
        launches["cli_vtn"] = cli_launches("cli_vtn", failures)
        vtn_ms = [h["train/step_time_sec"] * 1e3 for h in vtn.history if "train/loss" in h]
        log(f"cli VTN: vc_train ms a step {[round(x, 1) for x in vtn_ms]}, vc_decode "
            f"{r['frames']} mel frames at {r['frames_per_sec']:.1f} mel-frames/s; card {card}")
        wavs = list((root / "dec_vtn" / "wav").glob("*.wav"))
        if vtn.steps != 2 or len(wavs) != 2 or not (exp_vtn / "predictions" / "2steps").is_dir():
            failures.append(f"cli VTN: steps {vtn.steps}, wavs {len(wavs)}")
    return failures, launches


# ----------------------------------------------------------- FastSpeech-VC
def fs2_model(seed: int, **over):
    """FastSpeech-VC at the full width of FS2_CONF on the CPU, seeded as
    ``flagship`` seeds the AAS-VC; ``over`` replaces config fields."""
    from seq2seq_vc_torch.models.fastspeech_vc import FastSpeechVC

    torch.manual_seed(seed)
    model = FastSpeechVC(**dict(FS2, **over))
    perturb_(model, seed)
    return model


def teacher_durations(n_src: int, n_trg: int, rng) -> np.ndarray:
    """Integer durations, one per encoder frame of an ``n_src``-frame source
    (after the x4 subsampling), that sum to ``n_trg``, as a teacher gives."""
    from seq2seq_vc_torch.models.common import conv2d_subsampled_lengths

    t_enc = conv2d_subsampled_lengths(n_src)
    return rng.multinomial(n_trg, np.ones(t_enc) / t_enc)


def write_durations(root: Path, lens, seed: int, utt_ids) -> str:
    """Each utterance's teacher durations as ``<utt>.txt``, written as
    ``vc_decode`` writes them; returns the directory."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for utt, (n_src, n_trg) in zip(utt_ids, lens):
        np.savetxt(root / f"{utt}.txt", teacher_durations(n_src, n_trg, rng)[None], fmt="%d")
    return str(root)


def fs2_loader(root: Path, lens, seed: int):
    """``corpus_loader``'s corpus plus teacher durations, read back through
    the port's dataset (with ``durations_dir``), NAR collater and loader."""
    from seq2seq_vc_torch.train.data import DataLoader, NARVCCollater, ParallelVCMelDataset

    corpus_loader(root, lens, seed)
    dur = write_durations(root / "durations", lens, seed, [f"utt{i:03d}" for i in range(len(lens))])
    src, trg = str(root / "src_feat.scp"), str(root / "trg_feat.scp")
    data = ParallelVCMelDataset(src, trg, dp_feats=src, durations_dir=dur)
    return DataLoader(data, NARVCCollater(PAD_MULTIPLE), BATCH, seed=seed)


def make_fs2_trainer(state, loader, steps: int, device=None):
    """A ``NARVCTrainer`` with the YAML's criteria that takes ``steps`` more
    optimizer steps on ``state``."""
    from seq2seq_vc_torch.losses import get_criterion
    from seq2seq_vc_torch.train.nar_vc import NARVCTrainer

    config = dict(TRAIN_CONFIG, train_max_steps=state.steps + steps)
    return NARVCTrainer(state, {n: get_criterion(n) for n in FS2_CRITERIONS}, config, loader,
                        device=device or DEVICE)


def fs2_serve_path(rows, src, trg):
    """Phase 23, serving: FastSpeech-VC with phase 2's HiFi-GAN serves phase
    2's three requests (a warm-up pass, then the timed one with the launch
    counts set to 0 just before and read just after), kernels 1 and 2
    checked at every shape it gave them, then a float32 conversion of one
    clip on the card and on the CPU. Returns (failures, launches)."""
    from seq2seq_vc_torch.pipeline import Wav2WavConverter

    failures = []
    with torch.no_grad():
        model = fs2_model(seed=70).eval()
        vocoder = build_vocoder(seed=71)
        conv = Wav2WavConverter(model, vocoder, src, trg, FEATS)
        requests = serving_requests()
        log("fs2 serving: FastSpeech-VC at full width (bf16), warm-up: each request once")
        fails, warm = serve(conv, requests)
        failures += fails
        calls = planned_calls(conv, requests, [r["out_frames"] for r in warm])
        expected = {n: sum(c[0] == n for c in calls) for n in KERNELS}
        for name, B, H, T, D, lens in sorted(set(calls)):
            rows.append(check_kernel(name, B, H, T, D, torch.bfloat16, seed=T + D, label="fs2",
                                     lens=list(lens)))
        log("fs2 serving main path: the same requests again")
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        fails, timed = serve(conv, requests)
        launches = launch_counts()
        failures += fails
        for (label, clips), r in zip(requests, timed):
            _, _, max_out = conv._frame_geometry([len(c) + conv.fft_size for c in clips])
            log(f"fs2 request {label}: predicted output frames {r['out_frames']} (input "
                f"{[len(c) // conv.hop_size + 1 for c in clips]} frames, decoder length "
                f"{max_out}); latency {r['ms']:.1f} ms")
        log(f"fs2 serving launches {launches}, expected from the routing {expected}; peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for name in KERNELS:
            got = launches[name]
            if got != expected[name] or (got == 0 and name in PATH_KERNELS["fs2_serve"]):
                failures.append(f"fs2_serve {name}: {got} launches, expected {expected[name]}")
        if warm[-1]["out_frames"] != timed[-1]["out_frames"]:
            failures.append(f"fs2_serve: output lengths changed: {warm} {timed}")

        m32 = fs2_model(seed=70, compute_dtype="float32", flash_min_len=256).eval()
        v32 = copy.deepcopy(vocoder)
        v32.compute_dtype = torch.float32
        audio = clip(1.0, seed=7)
        wavs, counts = {}, {}
        for side, dev in (("card", "cuda"), ("cpu", "cpu")):
            c = Wav2WavConverter(copy.deepcopy(m32), copy.deepcopy(v32), src, trg, FEATS,
                                 device=dev)
            before = launch_counts()
            wavs[side] = c(audio)
            counts[side] = {k: v - before[k] for k, v in launch_counts().items()}
        a, b = wavs["card"], wavs["cpu"]
        err = float(np.abs(a - b).max()) if len(a) == len(b) else float("inf")
        others = set(KERNELS) - set(PATH_KERNELS["fs2_serve"])
        ok = err <= REFERENCE_ATOL and all(counts["card"][n] for n in PATH_KERNELS["fs2_serve"]) \
            and not any(counts["card"][n] for n in others) and not any(counts["cpu"].values())
        log(f"fs2 reference float32 1.0 s clip: card {len(a)} samples, cpu {len(b)} samples, max "
            f"abs diff {err:.3e} (atol {REFERENCE_ATOL}); launches card {counts['card']}, cpu "
            f"{counts['cpu']}: {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"fs2 reference check: card vs cpu diff {err}, lengths {len(a)} {len(b)}")
        del conv, model, vocoder
    return failures, launches


def fs2_train_steps(state, loader, batch, path, rows, warm: int, steps: int):
    """A warm-up, the kernel checks at the batch's shapes, ``steps`` timed
    steps (launch counts set to 0 just before, read just after, held to the
    routing's prediction), finite loss and gradients, a profile of one
    step. Returns (failures, launches)."""
    failures = []
    label = f"FS2 T{batch['xs'].shape[1]}/{batch['ys'].shape[1]}"
    train_steps(state, loader, warm, f"{label} warm-up", make=make_fs2_trainer)
    calls = train_calls(state.model, batch)
    for name, B, H, T, D, lens in sorted(set(calls)):
        rate = 0.2 if name in ("rel_flash_attention", *FLASH_BWD) else None
        rows.append(check_kernel(name, B, H, T, D, torch.bfloat16, seed=T + D, label="fs2",
                                 lens=list(lens), rate=rate))
    log(f"{path} main path: {steps} steps at {label}")
    notes, handle, n_att = watch_grads(state)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    trainer = train_steps(state, loader, steps, label, make=make_fs2_trainer)
    launches = launch_counts()
    handle.remove()
    expected = {n: steps * sum(c[0] == n for c in calls) for n in KERNELS}
    step_ms = [h["train/step_time_sec"] * 1e3 for h in trainer.history]
    log(f"{path}: ms/step {[round(x, 1) for x in step_ms]} (mean {np.mean(step_ms):.1f}); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches}, expected from the routing {expected}")
    for name in KERNELS:
        want = expected[name]
        if launches[name] != want or (launches[name] == 0 and name in PATH_KERNELS[path]):
            failures.append(f"{path} {name}: {launches[name]} launches, expected {want}")
    losses = [h["train/loss"] for h in trainer.history]
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"{path}: loss not finite: {losses}")
    finite = [bool(f) for f, _ in notes]
    att_min = [float(m) for _, m in notes]
    log(f"{path} gradients per step: all finite {finite}; smallest norm among the {n_att} "
        f"attention projections' weight gradients {att_min}")
    if len(notes) != steps or not all(finite) or not all(m > 0 for m in att_min):
        failures.append(f"{path}: gradients finite {finite}, attention grad norms {att_min}")
    profile_step(state, loader, float(np.mean(step_ms)), f"B{BATCH}, {label}",
                 port_kernels=("rel_scores_fwd_kernel", "rel_scores_bwd_kernel",
                               "rel_flash_fwd_kernel", "rel_flash_bwd_dq_kernel",
                               "rel_flash_bwd_dkv_kernel", "rel_flash_bwd_dpos_kernel"),
                 make=make_fs2_trainer)
    return failures, launches


def fs2_reference_step(seed: int):
    """One float32 ``NARVCTrainer`` step's loss and gradients, from the same
    weights and batch (B 2, 100-128 frames, teacher durations), dropout
    off and the flash gate at 64, so that the decoder takes the flash route
    (kernels 2, 6, 7, 8) and the encoder (31 frames) the fused one (1, 3),
    on the card and on the CPU (their plain versions), to phase 9's
    tolerances; a ReLU input that flipped sign between the devices holds its
    module's gradients to FLIP_RTOL."""
    from seq2seq_vc_torch.train.data import NARVCCollater

    model = fs2_model(seed, compute_dtype="float32", flash_min_len=64, **FS2_NO_DROPOUT).train()
    lens = [(128, 128), (100, 112)]
    items = feature_items(lens, seed)
    rng = np.random.default_rng(seed)
    for item, (n_src, n_trg) in zip(items, lens):
        item["duration"] = teacher_durations(n_src, n_trg, rng)
    batch = NARVCCollater(PAD_MULTIPLE)(items)
    runs = {}
    for side, dev in (("card", DEVICE), ("cpu", "cpu")):
        trainer = make_fs2_trainer(train_state(copy.deepcopy(model)), [], 1, device=dev)
        pre = {}  # the ReLUs' inputs
        for name, mod in trainer.model.named_modules():
            if name.endswith(FS2_RELU_INPUTS):
                mod.register_forward_hook(
                    lambda mod, args, out, name=name: pre.__setitem__(name, out.detach().cpu()))
        before = launch_counts()
        loss, metrics = trainer.loss_fn(trainer._array_batch(batch), trainer._flags(),
                                        trainer.generator)
        loss.backward()
        grads = {n: p.grad.detach().float().cpu() for n, p in trainer.model.named_parameters()
                 if p.grad is not None}
        counts = {k: v - before[k] for k, v in launch_counts().items()}
        runs[side] = (loss.item(), {k: v.item() for k, v in metrics.items()}, grads, counts, pre)
    (la, ma, ga, ca, pa), (lb, mb, gb, cb, pb) = runs["card"], runs["cpu"]
    flips = {n: [float(x) for x in pb[n][(pa[n] > 0) != (pb[n] > 0)]] for n in pb}
    flips = {n: xs for n, xs in flips.items() if xs}
    failures = [f"fs2 reference step {name}: card {a} cpu {b}"
                for name, a, b in [("loss", la, lb)] + [(k, ma[k], mb[k]) for k in mb]
                if not (math.isfinite(a) and abs(a - b) <= STEP_RTOL * abs(b))]
    if set(ga) != set(gb):
        failures.append(f"fs2 reference step: gradients of {sorted(set(ga) ^ set(gb))} on one side")
    top = max(float(g.abs().max()) for g in gb.values())
    worst = (0.0, "")
    for name in sorted(set(ga) & set(gb)):
        a, b = ga[name], gb[name]
        if name.endswith("linear_k.bias"):  # rounding noise on both devices
            if max(float(a.abs().max()), float(b.abs().max())) > NOISE_RTOL * top:
                failures.append(f"fs2 reference step {name}: not rounding noise")
            continue
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        flipped = name.rpartition(".")[0] in flips
        worst = max(worst, (rel, name)) if not flipped else worst
        if not (torch.isfinite(a).all() and rel <= (FLIP_RTOL if flipped else GRAD_RTOL)):
            failures.append(f"fs2 reference step {name}: gradient error {rel:.3e} of its largest")
    want = set(PATH_KERNELS["fs2_train_long"])
    if {n for n, v in ca.items() if v} != want or any(cb.values()):
        failures.append(f"fs2 reference step launches: card {ca}, cpu {cb}")
    log(f"fs2 reference float32 train step, flash route in the decoder (B 2, 100-128 frames, "
        f"dropout off): loss card {la:.6f} cpu {lb:.6f}; terms card {ma} cpu {mb}; {len(gb)} "
        f"gradient tensors, worst error of a tensor's largest {worst[0]:.3e} ({worst[1]}; rtol "
        f"{GRAD_RTOL}); ReLU inputs on opposite sides of 0 (cpu values) {flips} (their modules "
        f"rtol {FLIP_RTOL}); launches card {ca}, cpu {cb}: {'ok' if not failures else 'FAIL'}")
    return failures


def fs2_train_path(rows):
    """Phase 23, training: a ``NARVCTrainer`` on FastSpeech-VC at full width
    (bf16, dropout 0.2, the YAML's Adam, warmuplr and clipping), B 16 on a
    synthetic corpus with teacher durations: 3 steps at 160-512 target
    frames (kernels 1 and 3), 2 at 2048-2304 (the decoder on kernels 2 and
    6-8 at D 192, the encoder's 511-575 frames on 1 and 3), then the float32
    reference step. Returns (failures, launches by path)."""
    failures, launches = [], {}
    tmp = REPO / "build"
    tmp.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=tmp, prefix="chip_smoke_fs2_") as root:
        state = train_state(fs2_model(seed=72).train().to(DEVICE))
        log(f"fs2 training: NARVCTrainer, FastSpeech-VC at full width (bf16, dropout 0.2), "
            f"B{BATCH}")
        for path, lens, warm, steps in (("fs2_train", corpus_lens(160, 512, seed=73), 1, 3),
                                        ("fs2_train_long", long_lens(seed=74), 1, 2)):
            loader = fs2_loader(Path(root) / path, lens, seed=75)
            batch = next(iter(loader))
            log(f"{path}: sources {sorted(batch['ilens'].tolist())}, targets "
                f"{sorted(batch['olens'].tolist())} frames, padded (xs, ys, durations) "
                f"{batch['xs'].shape}, {batch['ys'].shape}, {batch['durations'].shape}")
            fails, launches[path] = fs2_train_steps(state, loader, batch, path, rows, warm, steps)
            failures += fails
            torch.cuda.empty_cache()
        del state
    failures += fs2_reference_step(seed=76)
    return failures, launches


def fs2_cli_path(rows):
    """Phase 23, the CLIs on FS2_CONF: ``vc_train`` with teacher durations
    (``--train-duration-dir``) for 3 steps with an evaluation and a
    checkpoint at step 2, then ``--resume`` to step 4; ``vc_decode`` of the
    dev set through a seeded HiFi-GAN (batch size 1, then 4), one
    utterance held against ``FastSpeechVC.inference``; ``vc_serve`` over
    stdio with 3 requests, the last long enough that the decoder's keys
    reach the flash gate. Each kernel is checked at the shapes each CLI
    gave it. Returns (failures, launches by path)."""
    import argparse
    import contextlib
    import io

    import yaml

    from seq2seq_vc_torch.bin import vc_decode, vc_serve, vc_train
    from seq2seq_vc_torch.core.config import load_config
    from seq2seq_vc_torch.nn.attention import FLASH_MIN_LEN
    from seq2seq_vc_torch.train.data import (DataLoader, ParallelVCMelDataset,
                                             SourceVCMelDataset, pad_batch)
    from seq2seq_vc_torch.utils.audio import write_wav

    failures, launches = [], {}
    card = card_line()
    sr, hop = FEATS["sampling_rate"], FEATS["hop_size"]
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="chip_smoke_fs2_cli_") as tmp:
        root = Path(tmp)
        c = cli_corpus(root)
        for subset in ("train", "dev"):
            lines = [ln.split() for ln in Path(c[f"src_{subset}"]).read_text().splitlines()]
            trg = dict(ln.split() for ln in Path(c[f"trg_{subset}"]).read_text().splitlines())
            lens = [(np.load(p, mmap_mode="r").shape[0], np.load(trg[u], mmap_mode="r").shape[0])
                    for u, p in lines]
            c[f"dur_{subset}"] = write_durations(root / "durations", lens, seed=77,
                                                 utt_ids=[u for u, _ in lines])
        torch.save(build_vocoder(seed=78).state_dict(), root / "hifigan.pt")
        gen = {k: [list(x) if isinstance(x, tuple) else x for x in v] if isinstance(v, tuple)
               else v for k, v in HIFIGAN.items()}
        (root / "hifigan.yaml").write_text(yaml.safe_dump(
            {"generator_type": "HifiganGenerator", "generator_params": gen}))
        vocoder = {"checkpoint": str(root / "hifigan.pt"), "config": str(root / "hifigan.yaml")}

        def overlay(name, **keys):
            (root / name).write_text(yaml.safe_dump(keys))
            return ["--additional-config", str(root / name)]

        exp = root / "exp"
        args = ["--src-train-dumpdir", c["src_train"], "--src-dev-dumpdir", c["src_dev"],
                "--trg-train-dumpdir", c["trg_train"], "--trg-dev-dumpdir", c["trg_dev"],
                "--trg-stats", c["trg_stats"], "--train-dp-input-dir", c["src_train"],
                "--dev-dp-input-dir", c["src_dev"], "--train-duration-dir", c["dur_train"],
                "--dev-duration-dir", c["dur_dev"], "--config", str(FS2_CONF),
                "--outdir", str(exp)]
        every = dict(eval_interval_steps=2, save_interval_steps=2, log_interval_steps=1)
        log(f"fs2 cli: vc_train on {FS2_CONF.relative_to(REPO)} with teacher durations, "
            f"{BATCH} train and {CLI_DEV} dev utterances; 3 steps, then --resume to 4")
        reset_launch_counts()
        first = vc_train.main(args + overlay("fs2_steps3.yaml", train_max_steps=3, **every))
        resumed = vc_train.main(args + overlay("fs2_steps4.yaml", train_max_steps=4, **every)
                                + ["--resume", str(exp / "checkpoint-3steps.pt")])
        launches["fs2_cli_train"] = cli_launches("fs2_cli_train", failures)
        history = [h for t in (first, resumed) for h in t.history if "train/loss" in h]
        dev = [h for h in first.history if "dev/loss" in h]
        for h in history:
            log(f"fs2 cli vc_train step {h['steps']}: {h['train/step_time_sec'] * 1e3:.1f} ms, "
                f"loss {h['train/loss']:.4f} (l1 {h['train/l1_loss']:.4f}, duration "
                f"{h['train/duration_loss']:.4f})")
        log(f"fs2 cli vc_train: {history[1]['train/step_time_sec'] * 1e3:.1f} ms a step (step 2, "
            f"B {BATCH}); dev at step 2 {dev}; card {card}")
        made = [exp / n for n in ("config.yml", "checkpoint-2steps.pt", "checkpoint-3steps.pt",
                                  "checkpoint-4steps.pt")]
        if ([h["steps"] for h in history] != [1, 2, 3, 4] or resumed.steps != 4 or len(dev) != 1
                or not all(math.isfinite(h["train/loss"]) for h in history)
                or not all(p.exists() for p in made) or (exp / "predictions").exists()):
            failures.append(f"fs2 cli vc_train: steps {[h['steps'] for h in history]}, files "
                            f"{[p.exists() for p in made]}, dev {dev}")
        cfg = load_config(str(exp / "config.yml"))
        dtype = torch.bfloat16 if cfg["model_params"].get("compute_dtype") == "bfloat16" \
            else torch.float32
        train_set = ParallelVCMelDataset(c["src_train"], c["trg_train"], dp_feats=c["src_train"],
                                         durations_dir=c["dur_train"])
        batch = next(iter(DataLoader(train_set, vc_train.build_collater(cfg), BATCH, prefetch=0)))
        for name, B, H, T, D, lens in sorted(set(train_calls(resumed.model, batch))):
            rows.append(check_kernel(name, B, H, T, D, dtype, seed=T + D, label="fs2",
                                     lens=list(lens)))
        del first, resumed

        ckpt = str(exp / "checkpoint-4steps.pt")
        (root / "decode.yml").write_text(yaml.safe_dump(dict(cfg, vocoder=vocoder)))
        reset_launch_counts()
        decodes = (("batch size 1", 1, "dec1"), ("batched", 4, "dec4"))
        for label, bs, out in decodes:
            r = vc_decode.main(["--dumpdir", c["src_dev"], "--dp-input-dir", c["src_dev"],
                                "--checkpoint", ckpt, "--config", str(root / "decode.yml"),
                                "--outdir", str(root / out), "--batch-size", str(bs)])
            log(f"fs2 cli vc_decode {label}: {CLI_DEV} utterances, {r['frames']} mel frames in "
                f"{r['seconds'] * 1e3:.1f} ms, {r['frames_per_sec']:.1f} mel-frames/s; card {card}")
            wavs = list((root / out / "wav").glob("*.wav"))
            durs = list((root / out / "durations").glob("*.txt"))
            if len(wavs) != CLI_DEV or len(durs) != CLI_DEV or r["frames"] <= 0:
                failures.append(f"fs2 cli vc_decode {label}: {len(wavs)} wavs, {len(durs)} "
                                f"durations, {r['frames']} frames")
        launches["fs2_cli_decode"] = cli_launches("fs2_cli_decode", failures)
        model = vc_decode.load_model(cfg, ckpt, "cuda")
        for name, B, H, T, D, lens in sorted({call for _, bs, out in decodes
                                              for call in decode_calls(model, c["src_dev"], bs,
                                                                       root / out)}):
            rows.append(check_kernel(name, B, H, T, D, dtype, seed=T + D, label="fs2",
                                     lens=list(lens)))
        item = SourceVCMelDataset(c["src_dev"], dp_feats=c["src_dev"])[0]
        xs, dp = (torch.as_tensor(pad_batch([item[k]], vc_decode.frame_multiple(model)),
                                  device="cuda") for k in ("src_feat", "dp_input"))
        out = model.inference(xs, torch.tensor([len(item["src_feat"])], device="cuda"), dp,
                              max_output_frames=2 * xs.shape[1])
        n = min(int(out["out_lens"][0]), out["outs"].shape[1])
        want = out["outs"][0, :n].float().cpu().numpy()
        got = np.load(root / "dec1" / f"{item['utt_id']}.npy")
        err = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
        dur = np.loadtxt(root / "dec1" / "durations" / f"{item['utt_id']}.txt", ndmin=1)
        same_dur = np.array_equal(dur, out["d_outs"][0, : int(out["d_lens"][0])].cpu().numpy())
        ok = err <= CLI_DECODE_ATOL and same_dur
        log(f"fs2 cli vc_decode {item['utt_id']} vs FastSpeechVC.inference on the same weights "
            f"and input: shapes {got.shape} {want.shape}, max abs diff {err:.3e} (atol "
            f"{CLI_DECODE_ATOL}), durations equal {same_dur}: {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"fs2 cli vc_decode vs FastSpeechVC.inference: diff {err}, "
                            f"durations equal {same_dur}")
        del model

        # the long request: the decoder's keys (twice the padded source
        # frames, plus 8) reach the flash gate
        long_s = FLASH_MIN_LEN * hop / (2 * sr) + 0.5
        clips = [(f"{s:.1f} s", clip(s, 80 + i)) for i, s in enumerate((3.8, 2.2, long_s))]
        lines = []
        for i, (_, audio) in enumerate(clips):
            write_wav(str(root / f"req{i}.wav"), audio, sr)
            lines.append(f"{root / f'req{i}.wav'} {root / f'res{i}.wav'}")
        serve = dict(checkpoint=ckpt, config=None, src_stats=c["src_stats"],
                     trg_stats=c["trg_stats"], vocoder_checkpoint=vocoder["checkpoint"],
                     vocoder_config=vocoder["config"], vocoder_stats=None, feat_type="mel",
                     bucket_frames=128, device=None)
        argv = [a for k, v in serve.items() if v is not None
                for a in (f"--{k.replace('_', '-')}", str(v))]
        reset_launch_counts()
        stdin, sys.stdin = sys.stdin, io.StringIO("\n".join(lines) + "\n")
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                vc_serve.main(argv)
        finally:
            sys.stdin = stdin
        launches["fs2_cli_serve"] = cli_launches("fs2_cli_serve", failures)
        results = [json.loads(x) for x in buf.getvalue().splitlines()]
        if results[:1] != [{"ready": True}] or len(results) != 1 + len(clips) \
                or not all(r.get("ok") for r in results[1:]):
            failures.append(f"fs2 cli vc_serve: {results}")
        for (label, _), r in zip(clips, results[1:]):
            log(f"fs2 cli vc_serve request {label}: wall {r.get('wall_ms')} ms, RTF "
                f"{r.get('rtf')}, output {r.get('output_seconds')} s; card {card}")
        conv = vc_serve.build_converter(argparse.Namespace(**serve))
        out_frames = [[round(r["output_seconds"] * sr / hop)] for r in results[1:]]
        for name, B, H, T, D, lens in sorted(set(planned_calls(
                conv, [(label, [a]) for label, a in clips], out_frames))):
            rows.append(check_kernel(name, B, H, T, D, dtype, seed=T + D, label="fs2",
                                     lens=list(lens)))
        del conv
    return failures, launches


def fs2_path(rows, src, trg):
    """Phase 23: FastSpeech-VC serving, training and CLIs. Returns
    (failures, launches by path)."""
    failures, launches = fs2_serve_path(rows, src, trg)
    launches = {"fs2_serve": launches}
    torch.cuda.empty_cache()
    fails, train = fs2_train_path(rows)
    failures += fails
    launches.update(train)
    torch.cuda.empty_cache()
    fails, cli = fs2_cli_path(rows)
    failures += fails
    launches.update(cli)
    return failures, launches


# ------------------------------------------------ Transformer-TTS, TTS-AEPT
TTS_CONF = REPO / "egs/ljspeech/tts1/conf/transformer_tts.v1.yaml"
AEPT_CONF = REPO / "egs/ljspeech/tts1/conf/tts_aept.v1.yaml"
FINETUNE_CONF = REPO / "egs/arctic/vc1/conf/vtn.tts_pt.v1.yaml"
TTS_TRAIN, TTS_DEV = 16, 4  # sentences of the synthetic corpus (one batch of the conf's 16)
TTS_CHARS = (40, 180)  # characters a sentence, spread over the corpus (LJSpeech-like)
TTS_FRAMES = (150, 600)  # mel frames a sentence, rising with its characters
TTS_DECODE = ("The quick brown fox.", "A lazy dog.", "Printing, in short.")
TTS_STEPS = 3  # tts_train and the AEPT stage
# the long AEPT step: a batch's memory, reckoned before it is chosen. Each
# decoder layer keeps for the backward, per item and head, its self-attention
# softmax (float32), dropout mask (bool) and dropped weights (float32) over
# T x T, the same over T x T_mem for its cross-attention, and the guided
# loss's float32 stack of the cross maps; one layer at a time adds up to
# five float32 T x T tensors in flight (scores, masked scores, softmax,
# masked weights, dropped weights, or their gradients in the backward)
AEPT_LONG_BUDGET = 0.85  # of the card's memory
TTS_WORDS = ("the", "of", "and", "to", "a", "in", "was", "he", "that", "his", "which", "it",
             "by", "prisoner", "printing", "commission", "president", "oswald", "letter",
             "evidence", "seventeen", "hundred", "mister", "jury", "street", "morning",
             "house", "police", "building", "nineteen", "sixty", "three", "window")


def tts_sentences(n: int, seed: int):
    """``n`` sentences whose lengths spread over TTS_CHARS, from TTS_WORDS
    and a number now and then."""
    rng = np.random.default_rng(seed)
    out = []
    for target in np.linspace(*TTS_CHARS, n).round().astype(int):
        words = []
        while len(" ".join(words)) < target - 8:
            words.append(str(rng.integers(2, 1900)) if rng.random() < 0.05
                         else str(rng.choice(TTS_WORDS)))
        out.append((" ".join(words).capitalize() + ".")[: int(target)])
    return out


def tts_corpus(root: Path, seed: int):
    """Texts (a 2-column file), normalised log-mel-like features (``.npy``
    and a ``feats.scp``, frames rising with the characters) and their
    ``.npz`` stats for TTS_TRAIN + TTS_DEV sentences; the train and the dev
    lists; then the token list from ``tokenize_text`` (``phn`` with
    ``g2p_en``, which falls back to the native English G2P). Returns the
    paths by name."""
    from seq2seq_vc_torch.bin import tokenize_text
    from seq2seq_vc_torch.utils.io import write_stats

    rng = np.random.default_rng(seed)
    sents = tts_sentences(TTS_TRAIN + TTS_DEV, seed)
    lo, hi = TTS_CHARS
    paths = {}
    for subset, idx in (("train", range(TTS_TRAIN)), ("dev", range(TTS_TRAIN, len(sents)))):
        text, scp = [], []
        for i in idx:
            utt = f"LJ{i:03d}"
            frac = (len(sents[i]) - lo) / (hi - lo)
            n = int(TTS_FRAMES[0] + frac * (TTS_FRAMES[1] - TTS_FRAMES[0]))
            np.save(root / f"{utt}.npy", rng.standard_normal((n, 80)).astype(np.float32))
            text.append(f"{utt} {sents[i]}")
            scp.append(f"{utt} {root / f'{utt}.npy'}")
        for name, lines in ((f"{subset}_text", text), (f"{subset}_scp", scp)):
            paths[name] = str(root / f"{name}.txt")
            Path(paths[name]).write_text("\n".join(lines) + "\n")
    paths["all_text"] = str(root / "all_text.txt")
    Path(paths["all_text"]).write_text(Path(paths["train_text"]).read_text()
                                       + Path(paths["dev_text"]).read_text())
    paths["tokens"] = str(root / "tokens.txt")
    tokenize_text.main(["--input", paths["all_text"], "--output", paths["tokens"],
                        "--token_type", "phn", "--g2p", "g2p_en", "--cleaner", "tacotron"])
    paths["stats"] = str(root / "stats.npz")
    st = stats(5)
    write_stats(paths["stats"], st["mean"], st["scale"], "mel")
    return paths


class _GradWatch:
    """Notes, before every optimizer update in the process (a global
    ``torch.optim`` step pre-hook), whether each gradient is finite."""

    def __enter__(self):
        from torch.optim.optimizer import register_optimizer_step_pre_hook

        self.notes = []

        def hook(opt, args, kwargs):
            grads = [p.grad for g in opt.param_groups for p in g["params"] if p.grad is not None]
            self.notes.append(bool(torch.isfinite(torch.stack(torch._foreach_norm(grads))).all()))

        self.handle = register_optimizer_step_pre_hook(hook)
        return self

    def __exit__(self, *exc):
        self.handle.remove()


def aept_long_batch(t_out: int, t_mem: int, cfg) -> int:
    """The largest batch (1-4) of the long AEPT step whose reckoned memory
    (see AEPT_LONG_BUDGET) fits the card's budget, logged with the
    reckoning."""
    mp = cfg["model_params"]
    L, H = mp["dlayers"], mp["aheads"]
    per_item = L * H * (9 * t_out ** 2 + 13 * t_out * t_mem) + 20 * H * t_out ** 2
    total = torch.cuda.get_device_properties(0).total_memory
    fits = [b for b in range(1, 5) if b * per_item < AEPT_LONG_BUDGET * total]
    log(f"tts_aept_long: reckoned {per_item / 2**30:.2f} GiB an item at T_out {t_out}, T_mem "
        f"{t_mem} ({L} layers x {H} heads: self maps 9 bytes a cell, cross maps 13 with the "
        f"guided stack, 20 bytes a cell of one layer in flight); B 1-4: "
        f"{[round(b * per_item / 2**30, 1) for b in range(1, 5)]} GiB against "
        f"{AEPT_LONG_BUDGET} x {total / 2**30:.1f} GiB: B {max(fits, default=1)}")
    return max(fits, default=1)


def tts_path(rows):
    """Phase 24: Transformer-TTS and the VTN's TTS pretraining through the
    CLIs (``egs/ljspeech/tts1/run.sh`` stages 1, 3, 4 and 6). Appends the
    kernel checks to ``rows``; returns (failures, launches by path)."""
    import yaml

    from seq2seq_vc_torch.bin import tts_decode, tts_train, vc_train
    from seq2seq_vc_torch.core.checkpoint import init_from_checkpoint, module_keys
    from seq2seq_vc_torch.core.config import load_config
    from seq2seq_vc_torch.train.data import ARVCCollater

    failures, launches = [], {}
    card = card_line()
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="chip_smoke_tts_") as tmp:
        root = Path(tmp)
        c = tts_corpus(root, seed=70)

        def overlay(name, base=None, **keys):
            (root / name).write_text(yaml.safe_dump(dict(base or {}, **keys)))
            return ["--additional-config", str(root / name)]

        # (a) tts_train at the conf's full width, B 16
        exp = root / "exp_tts"
        tts = ["--train-dumpdir", c["train_scp"], "--dev-dumpdir", c["dev_scp"],
               "--train-text", c["train_text"], "--dev-text", c["dev_text"],
               "--token-list", c["tokens"], "--token-type", "phn", "--g2p", "g2p_en",
               "--cleaner", "tacotron", "--config", str(TTS_CONF), "--outdir", str(exp)]
        quiet = dict(eval_interval_steps=0, save_interval_steps=0, log_interval_steps=1)
        log(f"tts_train on {TTS_CONF.relative_to(REPO)}: {TTS_TRAIN} train and {TTS_DEV} dev "
            f"sentences of {TTS_CHARS[0]}-{TTS_CHARS[1]} characters, {TTS_FRAMES[0]}-"
            f"{TTS_FRAMES[1]} mel frames; {TTS_STEPS} steps")
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        with _GradWatch() as watch:
            trainer = tts_train.main(tts + overlay("tts_steps.yaml", train_max_steps=TTS_STEPS,
                                                   **quiet))
        launches["tts_train"] = cli_launches("tts_train", failures)
        peak = torch.cuda.max_memory_allocated() / 2**30
        hist = [h for h in trainer.history if "train/loss" in h]
        for h in hist:
            log(f"tts_train step {h['steps']}: {h['train/step_time_sec'] * 1e3:.1f} ms, loss "
                f"{h['train/loss']:.4f} (l1 {h['train/l1_loss']:.4f}, bce "
                f"{h['train/bce_loss']:.4f}, guided attention {h['train/guided_attn_loss']:.5f})"
                f", grad norm {h['train/grad_norm']:.4f}")
        batch = next(iter(trainer.train_loader))
        log(f"tts_train: B {len(batch['ilens'])}, tokens {sorted(batch['ilens'].tolist())} "
            f"(padded {batch['xs'].shape[1]}), frames {sorted(batch['olens'].tolist())} "
            f"(padded {batch['ys'].shape[1]}); {len(trainer.model.state_dict())} tensors; "
            f"ms a step {[round(h['train/step_time_sec'] * 1e3, 1) for h in hist]}; peak "
            f"device memory {peak:.2f} GiB; gradients finite before each update {watch.notes}; "
            f"card {card}")
        ga = [h["train/guided_attn_loss"] for h in hist]
        if (len(hist) != TTS_STEPS or not all(math.isfinite(h["train/loss"]) for h in hist)
                or not all(math.isfinite(g) and g > 0 for g in ga)
                or watch.notes != [True] * TTS_STEPS):
            failures.append(f"tts_train: steps {len(hist)}, losses "
                            f"{[h['train/loss'] for h in hist]}, guided {ga}, finite grads "
                            f"{watch.notes}")
        tts_ckpt = exp / f"checkpoint-{TTS_STEPS}steps.pt"
        del trainer

        # (b) tts_decode of a few short sentences, Griffin-Lim
        (root / "decode_text.txt").write_text(
            "".join(f"dec{i} {t}\n" for i, t in enumerate(TTS_DECODE)))
        reset_launch_counts()
        r = tts_decode.main(["--text", str(root / "decode_text.txt"), "--checkpoint",
                             str(tts_ckpt), "--token-list", c["tokens"], "--token-type", "phn",
                             "--g2p", "g2p_en", "--stats", c["stats"], "--outdir",
                             str(root / "tts_dec")])
        launches["tts_decode"] = cli_launches("tts_decode", failures)
        wavs = sorted((root / "tts_dec" / "wav").glob("*.wav"))
        frames = [np.load(root / "tts_dec" / f"dec{i}.npy").shape[0] for i in range(len(TTS_DECODE))]
        log(f"tts_decode: {len(TTS_DECODE)} sentences of {[len(t) for t in TTS_DECODE]} "
            f"characters -> {frames} frames (maxlenratio "
            f"{load_config(str(exp / 'config.yml'))['inference']['maxlenratio']} of the tokens "
            f"with eos), {r['ms_per_utt']:.1f} ms an utterance, {r['frames_per_sec']:.1f} "
            f"mel-frames/s; card {card}")
        if len(wavs) != len(TTS_DECODE) or min(frames) <= 0:
            failures.append(f"tts_decode: {len(wavs)} wavs, frames {frames}")

        # (c) the AEPT stage: vc_train with the recipe's arguments (the TTS
        # conf, tts_aept.v1.yaml, the TTS checkpoint), the steps cut
        aept_cfg = yaml.safe_load(AEPT_CONF.read_text())
        exp_a = root / "exp_aept"
        aept = ["--src-train-dumpdir", c["train_scp"], "--src-dev-dumpdir", c["dev_scp"],
                "--trg-train-dumpdir", c["train_scp"], "--trg-dev-dumpdir", c["dev_scp"],
                "--init-checkpoint", str(tts_ckpt), "--config", str(TTS_CONF)]
        log(f"tts_aept: vc_train --config {TTS_CONF.relative_to(REPO)} --additional-config "
            f"{AEPT_CONF.relative_to(REPO)} (steps cut to {TTS_STEPS}) --init-checkpoint "
            f"{tts_ckpt.name}")
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        with _GradWatch() as watch:
            trainer = vc_train.main(aept + ["--outdir", str(exp_a)] + overlay(
                "aept_steps.yaml", aept_cfg, train_max_steps=TTS_STEPS,
                **dict(quiet, save_interval_steps=1)))
        launches["tts_aept"] = cli_launches("tts_aept", failures)
        hist = [h for h in trainer.history if "train/loss" in h]
        cfg = load_config(str(exp_a / "config.yml"))
        src = torch.load(tts_ckpt, map_location="cpu", weights_only=True)["model"]
        steps = [torch.load(exp_a / f"checkpoint-{n}steps.pt", map_location="cpu",
                            weights_only=True)["model"] for n in (1, TTS_STEPS)]
        groups = module_keys(trainer.model)
        same = {m: [all(torch.equal(sd[k].cpu(), src[k]) for k in groups[m]) for sd in steps]
                for m in cfg["init-mods"]}
        prenet = [k for m in ("dprenet", "dprenet_proj") for k in groups[m]]
        prenet_moved = any(not torch.equal(steps[0][k], steps[1][k]) for k in prenet)
        enc_moved = any(not torch.equal(steps[0][k], steps[1][k]) for k in groups["encoder"])
        n_frozen = sum(not p.requires_grad for p in trainer.model.parameters())
        for h in hist:
            terms = h["train/l1_loss"] + h["train/bce_loss"] + h["train/guided_attn_loss"]
            log(f"tts_aept step {h['steps']}: {h['train/step_time_sec'] * 1e3:.1f} ms, loss "
                f"{h['train/loss']:.4f} = l1 {h['train/l1_loss']:.4f} + bce "
                f"{h['train/bce_loss']:.4f} + guided attention "
                f"{h['train/guided_attn_loss']:.5f} ({terms:.4f})")
        log(f"tts_aept: config use_guided_attn_loss {cfg.get('use_guided_attn_loss')}, "
            f"init-mods {cfg['init-mods']}, freeze-mods {cfg['freeze-mods']}; {n_frozen} frozen "
            f"parameter tensors; each init-mod equal to the TTS checkpoint's bit for bit at steps "
            f"1 and {TTS_STEPS} {same}; the prenet (dprenet, dprenet_proj: not a freeze-mod) "
            f"moved between them {prenet_moved}, the encoder {enc_moved}; gradients finite "
            f"{watch.notes}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {card}")
        if (len(hist) != TTS_STEPS or not all(all(v) for v in same.values()) or not prenet_moved
                or not enc_moved or n_frozen == 0 or watch.notes != [True] * TTS_STEPS
                or not all(math.isfinite(h["train/guided_attn_loss"])
                           and h["train/guided_attn_loss"] > 0 for h in hist)):
            failures.append(f"tts_aept: steps {len(hist)}, transferred and frozen {same}, "
                            f"prenet moved {prenet_moved}, encoder moved {enc_moved}, frozen "
                            f"{n_frozen}, finite grads {watch.notes}")
        aept_ckpt = exp_a / f"checkpoint-{TTS_STEPS}steps.pt"
        del trainer

        # (f) the fine-tune of egs/arctic/vc1/conf/vtn.tts_pt.v1.yaml from
        # the AEPT checkpoint (its init-mods, no freeze-mods), steps cut
        tune_cfg = yaml.safe_load(FINETUNE_CONF.read_text())
        exp_f = root / "exp_finetune"
        reset_launch_counts()
        trainer = vc_train.main(aept[:-4] + [
            "--init-checkpoint", str(aept_ckpt), "--config", str(exp_a / "config.yml"),
            "--outdir", str(exp_f)] + overlay("tune_steps.yaml", tune_cfg, train_max_steps=2,
                                              **quiet))
        launches["tts_finetune"] = cli_launches("tts_finetune", failures)
        hist = [h for h in trainer.history if "train/loss" in h]
        fresh = vtn_aept_model(load_config(str(exp_f / "config.yml")), None)
        done = init_from_checkpoint(fresh, str(aept_ckpt), tune_cfg["init-mods"])
        n_frozen = sum(not p.requires_grad for p in trainer.model.parameters())
        log(f"tts_finetune: vc_train --config exp_aept/config.yml --additional-config "
            f"{FINETUNE_CONF.relative_to(REPO)} (steps cut to 2) --init-checkpoint "
            f"{aept_ckpt.name}: ms a step {[round(h['train/step_time_sec'] * 1e3, 1) for h in hist]}"
            f", loss {[round(h['train/loss'], 4) for h in hist]}, {n_frozen} frozen tensors; "
            f"the modules its init-mods transfer {done}; card {card}")
        if (len(hist) != 2 or not all(math.isfinite(h["train/loss"]) for h in hist)
                or n_frozen or done != tune_cfg["init-mods"]):
            failures.append(f"tts_finetune: steps {len(hist)}, frozen {n_frozen}, "
                            f"transferred {done}")
        del trainer, fresh

        # (d) one long AEPT step, the encoder on the flash kernels
        n_pad = -(-VTN_LONG[1] // PAD_MULTIPLE) * PAD_MULTIPLE
        B = aept_long_batch(n_pad, ((n_pad - 1) // 2 - 1) // 2, cfg)
        lens = np.linspace(*VTN_LONG, B).round().astype(int).tolist()
        rng = np.random.default_rng(71)
        scp = []
        for i, n in enumerate(lens):
            np.save(root / f"long{i}.npy", rng.standard_normal((n, 80)).astype(np.float32))
            scp.append(f"long{i} {root / f'long{i}.npy'}")
        (root / "long.scp").write_text("\n".join(scp) + "\n")
        long_data = [a for k in ("src-train", "src-dev", "trg-train", "trg-dev")
                     for a in (f"--{k}-dumpdir", str(root / "long.scp"))]
        mp = dict(aept_cfg["model_params"], attention_backend="flash")
        log(f"tts_aept_long: one step at B {B}, sources = targets of {lens} frames, "
            f"attention_backend flash")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        with _GradWatch() as watch:
            trainer = vc_train.main(long_data + [
                "--init-checkpoint", str(tts_ckpt), "--config", str(TTS_CONF), "--outdir",
                str(root / "exp_long")] + overlay(
                "aept_long.yaml", aept_cfg, model_params=mp, batch_size=B, train_max_steps=1,
                **dict(quiet, save_interval_steps=0)))
        launches["tts_aept_long"] = counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        h = [h for h in trainer.history if "train/loss" in h][-1]
        want = {n: mp["elayers"] if n in STD else 0 for n in KERNELS}
        log(f"tts_aept_long: {h['train/step_time_sec'] * 1e3:.1f} ms for the step (the process's "
            f"first at this shape), loss {h['train/loss']:.4f} (guided attention "
            f"{h['train/guided_attn_loss']:.5f}), peak device memory {peak:.2f} GiB, gradients "
            f"finite {watch.notes}; launches {counts}, expected {want}; card {card}")
        if counts != want or not math.isfinite(h["train/loss"]) or watch.notes != [True]:
            failures.append(f"tts_aept_long: launches {counts}, loss {h['train/loss']}, "
                            f"finite grads {watch.notes}")
        batch = ARVCCollater(PAD_MULTIPLE, 1)([trainer.train_loader.dataset[i]
                                              for i in range(B)])
        att = trainer.model.encoder.encoders[0].self_attn
        calls = vtn_encoder_calls(trainer.model, batch["xs"].shape[1], batch["ilens"].tolist())
        log(f"tts_aept_long: encoder self-attention calls (B, H, T, D, key lengths) "
            f"{sorted(set(calls))}")
        del trainer
        torch.cuda.empty_cache()
        for name in STD:
            for b, H, T, D, kv_lens in sorted(set(calls)):
                rows.append(check_std_kernel(name, b, H, T, T, D, torch.float32, seed=T + 1,
                                             label="tts", lens=list(kv_lens),
                                             rate=att.dropout_rate))

        # (e) a float32 AEPT step card vs CPU: freeze-mods and guided attention
        model = vtn_aept_model(cfg, aept_ckpt)
        failures += ar_reference_step(
            model, lambda m, dev: aept_trainer(m, cfg, dev), seed=72,
            want={n: 0 for n in KERNELS}, label="AEPT reference step",
            route="dense, freeze-mods and guided attention")
    return failures, launches


def vtn_aept_model(cfg, checkpoint=None):
    """The AEPT stage's VTN, dropout off, with an AEPT checkpoint's weights
    (without one: seeded as ``vc_train`` seeds it)."""
    from seq2seq_vc_torch.models.vtn import VTN

    torch.manual_seed(cfg.get("seed", 0))
    model = VTN(**dict(cfg["model_params"], **VTN_NO_DROPOUT))
    if checkpoint is not None:
        state = torch.load(checkpoint, map_location="cpu", weights_only=True)["model"]
        model.load_state_dict(state)
    model.postnet.dropout_rate = 0.0
    return model.train()


def aept_trainer(model, cfg, device):
    """The AEPT stage's ``ARVCTrainer`` as ``vc_train`` builds it from ``cfg``
    (its criteria with guided attention, its optimizer with freeze-mods)."""
    from seq2seq_vc_torch.bin.vc_train import build_criterion, prepare_model
    from seq2seq_vc_torch.train.ar_vc import ARVCTrainer
    from seq2seq_vc_torch.train.state import TrainState

    config = dict(cfg, train_max_steps=1)
    return ARVCTrainer(TrainState(model, prepare_model(model, config, "")),
                       build_criterion(config), config, [], device=device)


# ------------------------------------------------------------ the vocoders
# phase 25: the recipes' vocoders at their published generator widths, as
# parallel_wavegan configs write them: parallel_wavegan.v1's PWG and
# melgan.v1's MelGAN; StyleMelGAN at the JAX class's defaults
# (seq2seq_vc_tpu/vocoder/melgan.py:210-219); the s3prl-vc Taco2-AR at the
# JAX class's defaults (taco2ar.py:82-97) over vtn.v1.melppg.yaml's 144-wide
# PPG, with the PWG as its inner vocoder
VOC_GENERATORS = {
    "pwg": ("ParallelWaveGANGenerator", dict(
        layers=30, stacks=3, residual_channels=64, gate_channels=128, skip_channels=64,
        aux_channels=80, aux_context_window=2, upsample_params={"upsample_scales": [4, 4, 4, 4]})),
    "melgan": ("MelGANGenerator", dict(
        in_channels=80, out_channels=1, kernel_size=7, channels=512, upsample_scales=[8, 8, 2, 2],
        stack_kernel_size=3, stacks=3, use_final_nonlinear_activation=True)),
    "style_melgan": ("StyleMelGANGenerator", dict(
        in_channels=128, aux_channels=80, channels=64, out_channels=1, kernel_size=9, dilation=2,
        noise_upsample_scales=[11, 2, 2, 2], upsample_scales=[2] * 8 + [1],
        gated_function="softmax")),
}
MELPPG_CONF = REPO / "egs/arctic/vc1/conf/vtn.v1.melppg.yaml"
PPG = "ppg_sxliu"
# the s3prl-vc downstream config: 10 ms PPG frames to 16 ms mel frames
TACO2_DS = {"model_type": "Taco2_AR", "sampling_rate": 16000, "hop_size": 256,
            "upstream_rate": 160, "num_mels": 80, "model_params": {}}
VOC_SECONDS = (3.8, 30.0)  # the inputs each vocoder is timed on
VOC_SHORT_SECONDS = 1.0  # the float32 card-vs-CPU input
# bf16 on the card against float32 on the card, max abs error over the
# float32 waveform's largest magnitude: bf16 operands (2^-9 relative
# rounding) through 30-40 conv layers; 0.8-1.0% measured on the CPU at 3.8 s
VOC_BF16_RTOL = 5e-2
# float32 card against CPU: sums in another order, through up to 40 layers
# (the Taco2-AR's mel through its AR steps)
VOC_F32_RTOL = 1e-4


def parallel_wavegan_state(module: torch.nn.Module):
    """``module``'s state dict as ``parallel_wavegan`` saves a weight-normed
    generator: each conv weight as ``weight_v`` and its row norms
    ``weight_g`` (axis 0), so that folding gives the weight back."""
    out = {}
    for key, w in module.state_dict().items():
        if key.endswith(".weight") and w.ndim >= 3:
            prefix = key[: -len(".weight")]
            out[f"{prefix}.weight_v"] = w
            out[f"{prefix}.weight_g"] = w.flatten(1).norm(dim=1).reshape(
                (-1,) + (1,) * (w.ndim - 1))
        else:
            out[key] = w
    return out


def voc_checkpoints(root: Path, seed: int):
    """Seeded generators written as ``parallel_wavegan`` checkpoints with
    configs, and the Taco2-AR as an s3prl-vc checkpoint (BatchNorm, as
    s3prl-vc trains it) with its mel stats and downstream config. Returns
    each ``vocoder:`` block by name."""
    import yaml

    from seq2seq_vc_torch.utils.io import write_stats
    from seq2seq_vc_torch.vocoder import melgan, pwg, taco2ar

    classes = {"pwg": pwg.ParallelWaveGANGenerator, "melgan": melgan.MelGANGenerator,
               "style_melgan": melgan.StyleMelGANGenerator}
    blocks = {}
    for i, (name, (gen_type, params)) in enumerate(VOC_GENERATORS.items()):
        widths = dict(params)
        if "upsample_params" in widths:  # parallel_wavegan nests PWG's scales
            widths["upsample_scales"] = widths.pop("upsample_params")["upsample_scales"]
        torch.manual_seed(seed + i)
        module = classes[name](**widths)
        perturb_(module, seed + i)
        torch.save({"model": {"generator": parallel_wavegan_state(module)}, "steps": 0},
                   root / f"{name}.pkl")
        (root / f"{name}.yaml").write_text(yaml.safe_dump(
            {"generator_type": gen_type, "generator_params": params, **FEATS}))
        blocks[name] = {"checkpoint": str(root / f"{name}.pkl"),
                        "config": str(root / f"{name}.yaml")}
    torch.manual_seed(seed + 10)
    model = taco2ar.Taco2AR(input_dim=144, norm_type="batch_norm", **TACO2_DS["model_params"])
    perturb_(model, seed + 10)
    torch.save({"model": model.state_dict(), "steps": 0}, root / "taco2ar.pkl")
    s = stats(seed + 11)
    write_stats(str(root / "taco2ar_stats.npz"), s["mean"], s["scale"])
    (root / "taco2ar.yaml").write_text(yaml.safe_dump(dict(TACO2_DS, vocoder=blocks["pwg"])))
    blocks["s3prl_vc"] = {"vocoder_type": "s3prl_vc", "checkpoint": str(root / "taco2ar.pkl"),
                          "config": str(root / "taco2ar.yaml"),
                          "stats": str(root / "taco2ar_stats.npz")}
    return blocks


def voc_timed(fn, seconds: float):
    """(ms, RTF, peak GiB) of one call of ``fn``, ending in a host fetch."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, ms / 1e3 / seconds, torch.cuda.max_memory_allocated() / 2 ** 30


def voc_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error over the reference's largest magnitude."""
    if got.shape != want.shape:
        return float("inf")
    return float((got.float().cpu() - want.float().cpu()).abs().max() / want.abs().max())


def voc_checks(name, block, mels, card):
    """One generator: its time, RTF and peak memory through ``get_vocoder``
    at 3.8 and 30 s (a second call at the length; the first is printed
    too); bf16 on the card against float32 on the card at 3.8 s; float32
    card against CPU at 1 s. Returns (failures, summary row)."""
    from seq2seq_vc_torch.vocoder import melgan, pwg
    from seq2seq_vc_torch.vocoder.vocoder import get_vocoder

    failures, row = [], {"name": name}
    voc = get_vocoder({"vocoder": block}, device="cuda")
    voc.decode(mels[VOC_SHORT_SECONDS])  # warm-up
    for s in VOC_SECONDS:  # the first call at a length, then the timed one
        _, cold, _, _ = voc_timed(lambda: voc.decode(mels[s]), s)
        y, ms, rtf, peak = voc_timed(lambda: voc.decode(mels[s]), s)
        row[s] = dict(cold_ms=cold, ms=ms, rtf=rtf, peak_gib=peak)
        if len(y) != len(mels[s]) * FEATS["hop_size"] or not np.isfinite(y).all():
            failures.append(f"voc {name} {s} s: {len(y)} samples, finite {np.isfinite(y).all()}")
    if name == "pwg":
        model = pwg.load_pwg_model(block["checkpoint"], block["config"], "cuda")
    else:
        model = melgan.load_melgan_model(block["checkpoint"], block["config"], "cuda",
                                         style=name == "style_melgan")
    m32 = copy.deepcopy(model)
    m32.compute_dtype = torch.float32

    def run(m, s, device="cuda"):
        c = torch.as_tensor(mels[s], device=device)[None]
        with torch.no_grad():
            return m(c, generator=torch.Generator().manual_seed(0))

    row["bf16_vs_f32"] = voc_err(run(model, VOC_SECONDS[0]), run(m32, VOC_SECONDS[0]))
    row["card_vs_cpu"] = voc_err(run(m32, VOC_SHORT_SECONDS),
                                 run(copy.deepcopy(m32).cpu(), VOC_SHORT_SECONDS, "cpu"))
    ok = row["bf16_vs_f32"] <= VOC_BF16_RTOL and row["card_vs_cpu"] <= VOC_F32_RTOL
    log(f"voc {name}: " + "; ".join(
        f"{s} s: {row[s]['ms']:.1f} ms (first call at the length {row[s]['cold_ms']:.1f}), RTF "
        f"{row[s]['rtf']:.5f}, peak {row[s]['peak_gib']:.2f} GiB" for s in VOC_SECONDS)
        + f"; bf16 vs float32 on the card (3.8 s): max abs err {row['bf16_vs_f32']:.3e} of the "
        f"peak (tol {VOC_BF16_RTOL}); float32 card vs CPU ({VOC_SHORT_SECONDS} s): "
        f"{row['card_vs_cpu']:.3e} (tol {VOC_F32_RTOL}): {'ok' if ok else 'FAIL'}; card {card}")
    if not ok:
        failures.append(f"voc {name}: bf16 {row['bf16_vs_f32']}, card vs cpu {row['card_vs_cpu']}")
    return failures, row


def taco2ar_checks(block, card):
    """The s3prl-vc vocoder: Taco2-AR's ms a step and kernel launches a step
    on 3.8 and 30 s of PPG frames (torch.profiler counts the launches of
    the 3.8 s decode), the two stages' time, RTF and peak memory, and a
    float32 Taco2-AR at prenet rate 0 on the card against the CPU (1 s)."""
    from torch.profiler import ProfilerActivity, profile

    from seq2seq_vc_torch.core.config import load_config
    from seq2seq_vc_torch.utils.io import read_stats
    from seq2seq_vc_torch.vocoder import taco2ar
    from seq2seq_vc_torch.vocoder.common import read_generator_state
    from seq2seq_vc_torch.vocoder.vocoder import get_vocoder

    failures, row = [], {"name": "s3prl_vc"}
    ds = load_config(block["config"])
    s = read_stats(block["stats"])
    downstream = taco2ar.build_downstream(block["checkpoint"], ds, s["mean"], s["scale"], "cuda")
    voc = get_vocoder({"vocoder": block}, device="cuda")
    rng = np.random.default_rng(90)
    ppg = {sec: rng.random((int(sec * 100), 144)).astype(np.float32)
           for sec in (VOC_SHORT_SECONDS, *VOC_SECONDS)}
    downstream(ppg[VOC_SHORT_SECONDS])  # warm-up
    for sec in VOC_SECONDS:
        mel, ms, _, _ = voc_timed(lambda: downstream(ppg[sec]), sec)
        y, all_ms, rtf, peak = voc_timed(lambda: voc.decode(ppg[sec]), sec)
        row[sec] = dict(steps=len(mel), ms_a_step=ms / len(mel), ms=all_ms, rtf=rtf,
                        peak_gib=peak)
        if len(y) != len(mel) * FEATS["hop_size"] or not np.isfinite(y).all():
            failures.append(f"voc s3prl_vc {sec} s: {len(y)} samples for {len(mel)} frames")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mel = downstream(ppg[VOC_SECONDS[0]])
        torch.cuda.synchronize()
    launches = sum(n for _, _, n in trace_kernels(prof))  # kernels and copies
    row["launches_a_step"] = launches / len(mel)
    state = read_generator_state(block["checkpoint"])
    models = {}
    for dev in ("cuda", "cpu"):
        m = taco2ar.Taco2AR(input_dim=144, resample_ratio=1.6, norm_type="batch_norm",
                            **dict(ds["model_params"], prenet_dropout_rate=0.0))
        m.load_state_dict(state)
        with torch.no_grad():
            models[dev] = m.to(dev).eval()(torch.as_tensor(ppg[VOC_SHORT_SECONDS], device=dev)[None])
    row["card_vs_cpu"] = voc_err(models["cuda"], models["cpu"])
    ok = row["card_vs_cpu"] <= VOC_F32_RTOL
    log("voc s3prl_vc (Taco2-AR + PWG): " + "; ".join(
        f"{sec} s: Taco2-AR {row[sec]['steps']} steps at {row[sec]['ms_a_step']:.3f} ms a step, "
        f"both stages {row[sec]['ms']:.1f} ms, RTF {row[sec]['rtf']:.5f}, peak "
        f"{row[sec]['peak_gib']:.2f} GiB" for sec in VOC_SECONDS)
        + f"; {launches} device activities (kernels and copies) in the 3.8 s Taco2-AR decode, "
        f"{row['launches_a_step']:.1f} a step; float32 Taco2-AR card vs CPU "
        f"({VOC_SHORT_SECONDS} s, prenet rate 0): {row['card_vs_cpu']:.3e} of the peak "
        f"(tol {VOC_F32_RTOL}): {'ok' if ok else 'FAIL'}; card {card}")
    if not ok:
        failures.append(f"voc s3prl_vc: card vs cpu {row['card_vs_cpu']}")
    return failures, row


def vocoder_path(rows):
    """Phase 25: the recipes' vocoders, through the entry points. (a)
    ``vc_decode`` of the AAS-VC flagship (``CLI_CONF``, seeded weights) with
    a ParallelWaveGAN ``vocoder:`` block over a 3.8 s and a 30 s utterance
    (the 30 s decoder past the flash gate: kernels 1 and 2, each checked at
    the shapes the decode gave it); (b) ``vc_decode`` of the full-width VTN
    of ``vtn.v1.melppg.yaml`` (odim 144, ``--feat-type ppg_sxliu``) through
    the s3prl-vc vocoder, its budget cut to ``VTN_INFERENCE``; (c)
    ``vocoder_anasyn_debug`` with MelGAN and with StyleMelGAN. Then each
    vocoder's time, RTF and peak memory at 3.8 and 30 s, bf16 against
    float32 and float32 card against CPU. Returns (failures, launches by
    path)."""
    import yaml

    from seq2seq_vc_torch.bin import vc_decode, vocoder_anasyn_debug
    from seq2seq_vc_torch.core.config import load_config
    from seq2seq_vc_torch.dsp.features import logmelfilterbank
    from seq2seq_vc_torch.dsp.stats import normalize
    from seq2seq_vc_torch.models.aas_vc import AASVC
    from seq2seq_vc_torch.models.vtn import VTN
    from seq2seq_vc_torch.utils.audio import read_wav, write_wav
    from seq2seq_vc_torch.utils.io import write_stats

    failures, launches = [], {}
    card = card_line()
    sr, hop = FEATS["sampling_rate"], FEATS["hop_size"]
    mel_kw = {k: v for k, v in FEATS.items() if k != "sampling_rate"}
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="chip_smoke_voc_") as tmp:
        root = Path(tmp)
        blocks = voc_checkpoints(root, seed=80)
        clips = {s: clip(s, 81 + i) for i, s in enumerate((VOC_SHORT_SECONDS, *VOC_SECONDS))}
        mels = {s: logmelfilterbank(a, sr, device="cuda", **mel_kw) for s, a in clips.items()}
        src, trg = stats(1), stats(2)
        write_stats(str(root / "src_stats.npz"), src["mean"], src["scale"], "mel")
        write_stats(str(root / "trg_stats.npz"), trg["mean"], trg["scale"], "mel")
        lines = []
        for s in VOC_SECONDS:
            np.save(root / f"src_{s}.npy", normalize(mels[s], src["mean"], src["scale"]))
            lines.append(f"utt_{s}s {root / f'src_{s}.npy'}")
        scp = root / "src.scp"
        scp.write_text("\n".join(lines) + "\n")

        # (a) the AAS-VC flagship's vc_decode through the PWG
        cfg = dict(load_config(str(CLI_CONF)), vocoder=blocks["pwg"])
        torch.manual_seed(82)
        model = AASVC(**cfg["model_params"])
        perturb_(model, 82)
        exp = root / "exp_aas"
        exp.mkdir()
        (exp / "config.yml").write_text(yaml.safe_dump(cfg))
        torch.save({"model": model.state_dict()}, exp / "checkpoint-0steps.pt")
        log(f"voc (a): vc_decode of {CLI_CONF.relative_to(REPO)} (seeded weights) with a "
            f"ParallelWaveGAN vocoder block, {VOC_SECONDS} s utterances, batch size 1")
        reset_launch_counts()
        r = vc_decode.main(["--dumpdir", str(scp), "--dp-input-dir", str(scp), "--checkpoint",
                            str(exp / "checkpoint-0steps.pt"), "--outdir", str(root / "dec_aas"),
                            "--trg-stats", str(root / "trg_stats.npz")])
        launches["voc_decode"] = cli_launches("voc_decode", failures)
        for line in lines:
            utt = line.split()[0]
            n = np.load(root / "dec_aas" / f"{utt}.npy").shape[0]
            y, _ = read_wav(str(root / "dec_aas" / "wav" / f"{utt}.wav"))
            log(f"voc (a) {utt}: {n} mel frames, {len(y)} samples")
            if len(y) != n * hop:
                failures.append(f"voc (a) {utt}: {len(y)} samples for {n} frames")
        log(f"voc (a): {r['frames']} frames in {r['seconds'] * 1e3:.1f} ms of decode "
            f"({r['frames_per_sec']:.1f} mel-frames/s); card {card}")
        model = vc_decode.load_model(cfg, str(exp / "checkpoint-0steps.pt"), "cuda")
        for name, B, H, T, D, lens in sorted(set(decode_calls(model, str(scp), 1,
                                                              root / "dec_aas"))):
            rows.append(check_kernel(name, B, H, T, D, torch.bfloat16, seed=T + D, label="voc",
                                     lens=list(lens)))
        del model

        # (b) the VTN with a PPG target, vocoded by the s3prl-vc vocoder
        cfg = load_config(str(MELPPG_CONF))
        cfg.update(inference=VTN_INFERENCE, vocoder=blocks["s3prl_vc"])
        torch.manual_seed(83)
        vtn = VTN(**cfg["model_params"])
        perturb_(vtn, 83)
        exp = root / "exp_vtn"
        exp.mkdir()
        (exp / "config.yml").write_text(yaml.safe_dump(cfg))
        torch.save({"model": vtn.state_dict()}, exp / "checkpoint-0steps.pt")
        del vtn
        ppg = stats(84)
        ppg = {k: np.resize(v, 144) for k, v in ppg.items()}
        write_stats(str(root / "ppg_stats.npz"), ppg["mean"], ppg["scale"], PPG)
        one = root / "src_one.scp"
        one.write_text(lines[0] + "\n")
        log(f"voc (b): vc_decode of {MELPPG_CONF.relative_to(REPO)} (odim 144, seeded weights, "
            f"inference {VTN_INFERENCE}) through the s3prl-vc vocoder, one {VOC_SECONDS[0]} s "
            f"utterance")
        reset_launch_counts()
        t0 = time.perf_counter()
        r = vc_decode.main(["--dumpdir", str(one), "--checkpoint",
                            str(exp / "checkpoint-0steps.pt"), "--outdir", str(root / "dec_vtn"),
                            "--trg-stats", str(root / "ppg_stats.npz"), "--feat-type", PPG])
        wall = time.perf_counter() - t0
        launches["voc_vtn"] = cli_launches("voc_vtn", failures)
        utt = lines[0].split()[0]
        feats = np.load(root / "dec_vtn" / f"{utt}.npy")
        y, _ = read_wav(str(root / "dec_vtn" / "wav" / f"{utt}.wav"))
        want = max(int(round(len(feats) / 1.6)), 1) * hop
        log(f"voc (b) {utt}: {feats.shape} PPG frames, {len(y)} samples (expected {want}); "
            f"decode {r['seconds'] * 1e3:.1f} ms, vc_decode wall {wall:.2f} s; card {card}")
        if feats.shape[1] != 144 or len(y) != want:
            failures.append(f"voc (b): features {feats.shape}, {len(y)} samples, want {want}")

        # (c) analysis-synthesis through MelGAN and StyleMelGAN
        wavs = root / "wavs"
        wavs.mkdir()
        for s in VOC_SECONDS:
            write_wav(str(wavs / f"clip_{s}s.wav"), clips[s], sr)
        reset_launch_counts()
        for name in ("melgan", "style_melgan"):
            (root / f"anasyn_{name}.yaml").write_text(yaml.safe_dump(
                dict(FEATS, vocoder=blocks[name])))
            out = root / f"anasyn_{name}"
            r = vocoder_anasyn_debug.main(["--rootdir", str(wavs), "--config",
                                           str(root / f"anasyn_{name}.yaml"), "--outdir",
                                           str(out), "--stats", str(root / "trg_stats.npz")])
            lens = {s: len(read_wav(str(out / f"clip_{s}s.wav"))[0]) for s in VOC_SECONDS}
            log(f"voc (c) vocoder_anasyn_debug {name}: {r['utterances']} utterances, "
                f"{r['audio_seconds']:.1f} s of audio, vocoder {r['seconds'] * 1e3:.1f} ms "
                f"(RTF {r['rtf']:.5f}, the first call included); samples {lens}; card {card}")
            if r["utterances"] != 2 or any(n != (1 + len(clips[s]) // hop) * hop
                                           for s, n in lens.items()):
                failures.append(f"voc (c) {name}: {r['utterances']} utterances, samples {lens}")
        launches["voc_anasyn"] = cli_launches("voc_anasyn", failures)

        # each vocoder alone
        mels = {s: m.astype(np.float32) for s, m in mels.items()}
        for name in VOC_GENERATORS:
            fails, _ = voc_checks(name, blocks[name], mels, card)
            failures += fails
            torch.cuda.empty_cache()
        fails, _ = taco2ar_checks(blocks["s3prl_vc"], card)
        failures += fails
    return failures, launches


# phase 26: the recipe's front end, aas_vc.ppgmelppg.v1.yaml's stages 1-2
# (preprocess, compute_statistics, normalize) on a corpus of 22.05 kHz wavs,
# then its stage 3-4 (vc_train, vc_decode) on what they wrote
FEAT_CONF = REPO / "egs/arctic/vc2/conf/aas_vc.ppgmelppg.v1.yaml"
FEAT_SR = 22050  # the corpus's rate: preprocess resamples it to the conf's 16 kHz
FEAT_SECONDS = (2.0, 5.0)  # 16 train and 4 dev clips a speaker spread over this range
FEAT_EDGE = 0.4  # seconds of near-silence at each end of the trimmed (dev) clips
# a recording cut by a kaldi segments file (seg2 is 3.8 s), and the 30 s clip
# as one segment of its own recording
FEAT_SEGMENTS = (("seg1", "rec", 0.3, 3.1), ("seg2", "rec", 3.6, 7.4),
                 ("long30", "long", 0.0, 30.0))
# the ppg_sxliu upstream: adim 144 and 4 heads, which the PPG confs' idim 144
# fixes; 576 linear units, 12 blocks and a conv kernel of 15 as the public
# ppg-vc conformer config is recalled (unverified: that file is not here)
PPG_UPSTREAM = dict(input_dim=80, adim=144, aheads=4, eunits=576, elayers=12,
                    cnn_module_kernel=15)
FEAT_TYPES = ("mel", "ppg_sxliu", "encodec")
FEAT_TIMED = (3.8, 30.0)  # the utterances each extractor is timed on (seg2, long30)
# float32 on the card against the CPU: the log-mel absolutely (log10 of sums
# in another order), the rest over their largest magnitude (float32 through
# 12 conformer blocks, the SEANet stacks and their LSTMs)
FEAT_MEL_ATOL = 1e-4
FEAT_RTOL_OF_PEAK = 1e-4
FEAT_STATS_RTOL = 1e-6  # of the largest: float64 sums in another order, rounded to float32
FEAT_NORM_ATOL = 1e-5  # float32 subtract and divide against numpy's


def feat_checkpoints(root: Path, seed: int):
    """The seeded ``ppg_sxliu`` upstream (espnet names; batch-norm running
    statistics away from 0 and 1), an s3prl-vc-style downstream holding
    only its featurizer weights, and an EnCodec state dict in HF names at
    the module's widths, every conv weight-normed. Returns the paths."""
    from seq2seq_vc_torch.encoders import encodec, ppg

    torch.manual_seed(seed)
    up = ppg.PPGUpstream(**PPG_UPSTREAM, device="cpu")
    perturb_(up, seed)
    g = torch.Generator().manual_seed(seed)
    for name, buf in up.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
        elif name.endswith("running_var"):
            buf.copy_(1 + 0.2 * torch.rand(buf.shape, generator=g))
    torch.save(up.state_dict(), root / "ppg_upstream.pt")
    weights = torch.randn(PPG_UPSTREAM["elayers"] + 1, generator=g)
    torch.save({"featurizer": {"weights": weights}, "steps": 0}, root / "ppg_downstream.pkl")
    state = {}
    for part, module in (("encoder", encodec.EncodecEncoder()),
                         ("decoder", encodec.EncodecDecoder())):
        perturb_(module, seed + 1)
        mods = dict(module.named_modules())
        for key, w in module.state_dict().items():
            mod, _, leaf = key.rpartition(".")
            if leaf == "weight" and isinstance(mods[mod], (torch.nn.Conv1d,
                                                           torch.nn.ConvTranspose1d)):
                norm = w.flatten(1).norm(dim=1).reshape(-1, 1, 1)
                state[f"{part}.{mod}.parametrizations.weight.original0"] = norm
                state[f"{part}.{mod}.parametrizations.weight.original1"] = w
            else:
                state[f"{part}.{key}"] = w
    torch.save(state, root / "encodec.pt")
    return (str(root / "ppg_upstream.pt"), str(root / "ppg_downstream.pkl"),
            str(root / "encodec.pt"))


def feat_corpus(root: Path):
    """The wavs and scps at ``FEAT_SR``: per speaker 16 train and 4 dev
    clips (the source's dev clips with near-silent edges, for the trimmed
    run), and the source's two recordings with their ``segments``. Returns
    {set: wav.scp path} and the original lengths by utterance."""
    from seq2seq_vc_torch.utils.audio import write_wav

    secs = np.linspace(*FEAT_SECONDS, BATCH + CLI_DEV)
    scps, lengths = {}, {}
    for spk, stretch, seed in (("src", 1.0, 300), ("trg", 1.1, 400)):
        for subset in ("train", "dev"):
            lines = []
            for i, s in enumerate(secs):
                if (i < BATCH) != (subset == "train"):
                    continue
                utt = f"{subset}{i:02d}"
                y = clip(s * stretch, seed + i, FEAT_SR)
                if spk == "src" and subset == "dev":
                    n = int(FEAT_EDGE * FEAT_SR)
                    y[:n] *= 1e-4
                    y[-n:] = 0.0
                write_wav(str(root / f"{spk}_{utt}.wav"), y, FEAT_SR)
                lengths[spk, utt] = len(y)
                lines.append(f"{utt} {root / f'{spk}_{utt}.wav'}")
            scps[spk, subset] = root / f"{spk}_{subset}_wav.scp"
            scps[spk, subset].write_text("\n".join(lines) + "\n")
    for rec, seconds, seed in (("rec", 8.0, 310), ("long", FEAT_SEGMENTS[-1][3], 311)):
        write_wav(str(root / f"{rec}.wav"), clip(seconds, seed, FEAT_SR), FEAT_SR)
    scps["src", "extra"] = root / "src_extra_wav.scp"
    scps["src", "extra"].write_text(f"rec {root / 'rec.wav'}\nlong {root / 'long.wav'}\n")
    (root / "segments").write_text("".join(f"{u} {r} {a} {b}\n" for u, r, a, b in FEAT_SEGMENTS))
    for utt, _, a, b in FEAT_SEGMENTS:
        lengths["src", utt] = int(b * FEAT_SR) - int(a * FEAT_SR)
    return scps, lengths


def trimmed_length(y: np.ndarray, conf) -> int:
    """Samples that the recipe's silence trim keeps of ``y``, worked out
    apart from ``preprocess.trim_silence``: frames of ``trim_frame_size``
    samples every ``trim_hop_size``, their mean power from cumulative sums
    of squares; the first and the last frame within
    ``trim_threshold_in_db`` of the loudest bound the span kept."""
    frame, step = conf["trim_frame_size"], conf["trim_hop_size"]
    if len(y) < frame:
        return len(y)
    c = np.concatenate([[0.0], np.cumsum(np.asarray(y, np.float64) ** 2)])
    starts = np.arange(0, len(y) - frame + 1, step)
    power = np.maximum((c[starts + frame] - c[starts]) / frame, 1e-20)
    loud = np.flatnonzero(power > power.max() * 10.0 ** (-conf["trim_threshold_in_db"] / 10))
    return min(len(y), starts[loud[-1]] + frame) - starts[loud[0]]


def feat_frames(n16: int, hop: int):
    """Frame counts as the JAX package computes them from the 16 kHz wave
    (n16 samples as read, before padding): the log-mel's 1 + n // hop, the
    wave padded to that many hops, the PPG's fbank (1 + n // 160) after the
    conv2d input layer's x4, EnCodec's ceil(n24 / 320) of the padded wave at
    24 kHz."""
    from seq2seq_vc_torch.utils.audio import resample

    mel = 1 + n16 // hop
    wave = mel * hop
    ppg = (((1 + wave // 160) - 1) // 2 - 1) // 2
    n24 = len(resample(np.zeros(wave, np.float32), 16000, 24000))
    return {"mel": mel, "wave": wave, "ppg_sxliu": ppg, "encodec": -(-n24 // 320)}


def feature_path(rows):
    """Phase 26: the recipe's front end on the card, through the entry
    points. (a) a corpus at 22.05 kHz (``feat_corpus``) and seeded
    checkpoints (``feat_checkpoints``); (b) ``preprocess`` with an overlay
    of ``FEAT_CONF`` (``format: npy``; ``mel``, ``ppg_sxliu`` and
    ``encodec``), the source's dev set under ``trim_silence``, its
    recordings through ``segments``; (c) ``compute_statistics`` and
    ``normalize`` for ``mel`` and ``ppg_sxliu`` (and ``encodec``'s
    statistics); (d) ``vc_train`` of ``FEAT_CONF`` at full width on those
    features (3 steps, B 16: kernels 1 and 3, each checked at the step's
    shapes); (e) ``vc_decode`` of the dev set, the segments and the 30 s
    clip (kernel 1, checked at the decode's shapes), and ``get_vocoder``'s
    ``encodec`` block over the latents of the 3.8 and 30 s utterances.
    Checks: frame counts, finite arrays, the statistics against float64
    numpy, ``normalize`` against the formula, float32 card against CPU for
    each extractor and the decoder; ms and RTF of each at 3.8 and 30 s,
    peak memory. Returns (failures, launches by path)."""
    import yaml

    from seq2seq_vc_torch.bin import compute_statistics, normalize, preprocess, vc_decode, vc_train
    from seq2seq_vc_torch.core.config import load_config
    from seq2seq_vc_torch.dsp.features import LogMelExtractor
    from seq2seq_vc_torch.encoders import encodec, ppg
    from seq2seq_vc_torch.train.data import DataLoader, ParallelVCMelDataset
    from seq2seq_vc_torch.utils.audio import read_wav, resample
    from seq2seq_vc_torch.utils.io import read_stats
    from seq2seq_vc_torch.vocoder.vocoder import get_vocoder

    failures, launches = [], {}
    card = card_line()
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(dir=build, prefix="chip_smoke_feat_") as tmp:
        root = Path(tmp)
        up_ckpt, ds_ckpt, enc_ckpt = feat_checkpoints(root, seed=90)
        scps, lengths = feat_corpus(root)
        conf = load_config(str(FEAT_CONF))
        hop = conf["hop_size"]
        feat_list = {"mel": {}, "encodec": {"checkpoint": enc_ckpt},
                     "ppg_sxliu": {"checkpoint": ds_ckpt, "upstream_checkpoint": up_ckpt,
                                   "input_dim": PPG_UPSTREAM["input_dim"]}}
        for trim in (False, True):
            (root / f"pre_{trim}.yaml").write_text(yaml.safe_dump(
                dict(conf, format="npy", feat_list=feat_list, trim_silence=trim)))

        # (b) preprocess: five runs
        dump = {}
        t0 = time.perf_counter()
        for (spk, subset), scp in scps.items():
            dump[spk, subset] = root / "dump" / spk / subset / "raw"
            argv = ["--wav-scp", str(scp), "--dumpdir", str(dump[spk, subset]), "--config",
                    str(root / f"pre_{spk == 'src' and subset == 'dev'}.yaml")]
            if subset == "extra":
                argv += ["--segments", str(root / "segments")]
            r = preprocess.main(argv)
            log(f"feat preprocess {spk} {subset}: {r['utterances']} utterances, "
                f"{r['audio_seconds']:.1f} s of audio; seconds by type "
                f"{ {k: round(v, 3) for k, v in r['seconds'].items()} }; card {card}")
        log(f"feat preprocess: {time.perf_counter() - t0:.1f} s for the five runs")
        bad = []
        for (spk, subset), d in dump.items():
            for line in (d / "wave.scp").read_text().splitlines():
                utt = line.split()[0]
                arrays = {k: np.load(d / k / f"{utt}.npy") for k in ("wave", *FEAT_TYPES)}
                n16 = len(resample(np.zeros(lengths[spk, utt], np.float32), FEAT_SR, 16000))
                want = feat_frames(n16, hop)
                got = {"wave": len(arrays["wave"]), **{k: arrays[k].shape[0] for k in FEAT_TYPES}}
                widths = {k: arrays[k].shape[1] for k in FEAT_TYPES}
                trimmed = spk == "src" and subset == "dev"
                if trimmed:  # shorter than the clip: frames from the trim rule's own length
                    y, sr = read_wav(str(root / f"{spk}_{utt}.wav"))
                    want = feat_frames(trimmed_length(resample(y, sr, 16000), conf), hop)
                    if got["wave"] >= n16 - FEAT_EDGE * 16000:
                        bad.append(f"{spk} {utt}: not trimmed ({got['wave']} of {n16})")
                if got != want or widths != {"mel": conf["num_mels"], "encodec": encodec.EMBED_DIM,
                                             "ppg_sxliu": PPG_UPSTREAM["adim"]} \
                        or not all(np.isfinite(a).all() for a in arrays.values()):
                    bad.append(f"{spk} {subset} {utt}: frames {got}, expected {want}, widths "
                               f"{widths}")
        seg = {utt: np.load(dump["src", "extra"] / "ppg_sxliu" / f"{utt}.npy").shape[0]
               for utt in ("seg2", "long30")}
        log(f"feat frames: every utterance's wave, log-mel, PPG and EnCodec counts as JAX "
            f"computes them, all finite: {'ok' if not bad else bad}; PPG frames a second "
            f"{seg['long30'] / 30.0:.3f} (long30: {seg['long30']} for 30 s; the fbank's 10 ms "
            f"hop, then conv2d x4); mel frames a second {16000 / hop}")
        failures += [f"feat frames {b}" for b in bad]

        # (c) statistics and normalisation
        stats_path, norm = {}, {}
        for spk in ("src", "trg"):
            for feat in FEAT_TYPES:
                if feat == "encodec" and spk == "trg":
                    continue
                r = compute_statistics.main(["--rootdir", str(dump[spk, "train"]), "--config",
                                             str(root / "pre_False.yaml"), "--dumpdir",
                                             str(root / "stats" / spk / feat), "--feat_type",
                                             feat])
                stats_path[spk, feat] = r["path"]
                own = np.concatenate([np.load(p).astype(np.float64) for p in sorted(
                    (dump[spk, "train"] / feat).glob("*.npy"))])
                errs = [float(np.abs(r[k] - ref).max() / np.abs(ref).max())
                        for k, ref in (("mean", own.mean(0)), ("scale", own.std(0)))]
                ok = max(errs) <= FEAT_STATS_RTOL and r["path"].endswith("stats.npz")
                log(f"feat stats {spk} {feat}: {r['utterances']} utterances, mean and scale "
                    f"against float64 numpy: max abs err over the largest {max(errs):.2e} (tol "
                    f"{FEAT_STATS_RTOL}): {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"feat stats {spk} {feat}: {errs}, {r['path']}")
                if feat == "encodec":
                    continue
                for subset in ("train", "dev", "extra"):
                    if (spk, subset) not in dump:
                        continue
                    norm[spk, subset] = root / "dump" / spk / subset / "norm"
                    normalize.main(["--rootdir", str(dump[spk, subset]), "--dumpdir",
                                    str(norm[spk, subset]), "--stats", r["path"],
                                    "--feat_type", feat, "--config",
                                    str(root / "pre_False.yaml")])
        s = read_stats(stats_path["src", "ppg_sxliu"], "ppg_sxliu")
        x = np.load(dump["src", "train"] / "ppg_sxliu" / "train00.npy")
        y = np.load(norm["src", "train"] / "ppg_sxliu" / "train00.npy")
        err = float(np.abs(y - (x - s["mean"]) / s["scale"]).max())
        w_same = np.array_equal(np.load(norm["src", "train"] / "wave" / "train00.npy"),
                                np.load(dump["src", "train"] / "wave" / "train00.npy"))
        ok = err <= FEAT_NORM_ATOL and w_same
        log(f"feat normalize: src train00 PPG against (x - mean) / scale in numpy: max abs "
            f"err {err:.2e} (tol {FEAT_NORM_ATOL}), wave copied {w_same}: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"feat normalize: err {err}, wave copied {w_same}")

        # (d) vc_train of the PPG conf on those features
        scp = {(spk, subset, feat): str(d / f"{feat}.scp") for (spk, subset), d in norm.items()
               for feat in ("mel", "ppg_sxliu")}
        exp = root / "exp"
        (root / "steps.yaml").write_text(yaml.safe_dump(dict(train_max_steps=3,
                                                             log_interval_steps=1)))
        log(f"feat: vc_train on {FEAT_CONF.relative_to(REPO)} (full width), {BATCH} train "
            f"utterances, PPG sources and duration-predictor inputs, mel targets; 3 steps")
        reset_launch_counts()
        trainer = vc_train.main(
            ["--src-train-dumpdir", scp["src", "train", "ppg_sxliu"], "--src-dev-dumpdir",
             scp["src", "dev", "ppg_sxliu"], "--trg-train-dumpdir", scp["trg", "train", "mel"],
             "--trg-dev-dumpdir", scp["trg", "dev", "mel"], "--train-dp-input-dir",
             scp["src", "train", "ppg_sxliu"], "--dev-dp-input-dir",
             scp["src", "dev", "ppg_sxliu"], "--trg-stats", stats_path["trg", "mel"],
             "--src-feat-type", "ppg_sxliu", "--config", str(FEAT_CONF), "--additional-config",
             str(root / "steps.yaml"), "--outdir", str(exp)])
        launches["feat_train"] = cli_launches("feat_train", failures)
        history = [h for h in trainer.history if "train/loss" in h]
        cfg = load_config(str(exp / "config.yml"))
        train_set = ParallelVCMelDataset(scp["src", "train", "ppg_sxliu"],
                                         scp["trg", "train", "mel"],
                                         dp_feats=scp["src", "train", "ppg_sxliu"])
        batch = next(iter(DataLoader(train_set, vc_train.build_collater(cfg), BATCH,
                                     prefetch=0)))
        calls = train_calls(trainer.model, batch)
        want = {n: 3 * sum(c[0] == n for c in calls) for n in KERNELS}
        step_ms = [round(h["train/step_time_sec"] * 1e3, 1) for h in history]
        log(f"feat vc_train: ms a step {step_ms} (the first holds the warm-up), losses "
            f"{[round(h['train/loss'], 4) for h in history]}; launches as the routing "
            f"predicts ({ {n: c for n, c in want.items() if c} }): "
            f"{launches['feat_train'] == want}; card {card}")
        if ([h["steps"] for h in history] != [1, 2, 3]
                or not all(math.isfinite(h["train/loss"]) for h in history)
                or launches["feat_train"] != want):
            failures.append(f"feat vc_train: steps {[h['steps'] for h in history]}, launches "
                            f"{launches['feat_train']}, expected {want}")
        for name, B, H, T, D, lens in sorted(set(calls)):
            rows.append(check_kernel(name, B, H, T, D, torch.bfloat16, seed=T + D, label="feat",
                                     lens=list(lens)))
        del trainer

        # (e) vc_decode of the dev set, the segments and the 30 s clip
        dec_scp = root / "decode.scp"
        dec_scp.write_text("".join(Path(scp["src", sub, "ppg_sxliu"]).read_text()
                                   for sub in ("dev", "extra")))
        ckpt = str(exp / "checkpoint-3steps.pt")
        reset_launch_counts()
        r = vc_decode.main(["--dumpdir", str(dec_scp), "--dp-input-dir", str(dec_scp),
                            "--checkpoint", ckpt, "--outdir", str(root / "dec"),
                            "--trg-stats", stats_path["trg", "mel"], "--batch-size", "4"])
        launches["feat_decode"] = cli_launches("feat_decode", failures)
        model = vc_decode.load_model(cfg, ckpt, "cuda")
        calls = decode_calls(model, str(dec_scp), 4, root / "dec")
        want = {n: sum(c[0] == n for c in calls) for n in KERNELS}
        n_utts = len(dec_scp.read_text().splitlines())
        wavs = list((root / "dec" / "wav").glob("*.wav"))
        log(f"feat vc_decode (Griffin-Lim): {n_utts} utterances, {r['frames']} mel frames in "
            f"{r['seconds'] * 1e3:.1f} ms ({r['frames_per_sec']:.1f} mel-frames/s); launches "
            f"as the routing predicts ({ {n: c for n, c in want.items() if c} }): "
            f"{launches['feat_decode'] == want}; card {card}")
        if len(wavs) != n_utts or launches["feat_decode"] != want:
            failures.append(f"feat vc_decode: {len(wavs)} wavs, launches "
                            f"{launches['feat_decode']}, expected {want}")
        for name, B, H, T, D, lens in sorted(set(calls)):
            rows.append(check_kernel(name, B, H, T, D, torch.bfloat16, seed=T + D, label="feat",
                                     lens=list(lens)))
        del model

        # each extractor and the EnCodec decoder alone: card timings at 3.8 and
        # 30 s, float32 card against CPU at 3.8 s
        extra = dump["src", "extra"]
        waves = {s: np.load(extra / "wave" / f"{u}.npy") for s, u in zip(FEAT_TIMED,
                                                                          ("seg2", "long30"))}
        enc_stats = read_stats(stats_path["src", "encodec"], "encodec")
        latents = {s: (np.load(extra / "encodec" / f"{u}.npy") - enc_stats["mean"])
                   / enc_stats["scale"] for s, u in zip(FEAT_TIMED, ("seg2", "long30"))}
        mel_kw = dict(sampling_rate=16000, fft_size=conf["fft_size"], hop_size=hop,
                      num_mels=conf["num_mels"], fmin=conf["fmin"], fmax=conf["fmax"])
        enc = {d: encodec.load_encodec(enc_ckpt, d) for d in ("cuda", "cpu")}
        dec = {d: encodec.load_encodec_decoder(enc_ckpt, d) for d in ("cuda", "cpu")}
        fns = {d: {"mel": LogMelExtractor(**mel_kw, device=d),
                   "ppg": ppg.build_extractor(up_ckpt, ds_ckpt, input_dim=80, device=d),
                   "encodec": lambda w, d=d: encodec.encode(
                       enc[d], resample(w, 16000, 24000)).cpu().numpy()}
               for d in ("cuda", "cpu")}
        voc = get_vocoder({"vocoder": {"vocoder_type": "encodec", "checkpoint": enc_ckpt}},
                          enc_stats, device="cuda")
        timed = {}
        for s in FEAT_TIMED:
            for name, fn in (*fns["cuda"].items(), ("encodec decode", None)):
                call = (lambda: voc.decode(latents[s])) if fn is None else \
                    (lambda fn=fn: fn(waves[s]))
                call()  # the first call at the length
                out, ms, rtf, peak = voc_timed(call, s)
                timed[name, s] = (ms, rtf)
                if not np.isfinite(out).all() or (fn is None and len(out) != len(latents[s]) * 320):
                    failures.append(f"feat {name} {s} s: shape {out.shape}, finite "
                                    f"{np.isfinite(out).all()}")
        log("feat extractors on the card (a second call at the length): " + "; ".join(
            f"{name} {s} s {ms:.1f} ms (RTF {rtf:.5f})" for (name, s), (ms, rtf) in timed.items())
            + f"; card {card}")
        errs = {}
        w = waves[FEAT_TIMED[0]]
        for name in ("mel", "ppg", "encodec"):
            got, ref = fns["cuda"][name](w), fns["cpu"][name](w)
            scale = 1.0 if name == "mel" else float(np.abs(ref).max())
            errs[name] = float(np.abs(got - ref).max()) / scale if got.shape == ref.shape \
                else float("inf")
        with torch.no_grad():
            lat = torch.as_tensor(np.asarray(latents[FEAT_TIMED[0]], np.float32))[None]
            got, ref = dec["cuda"](lat.cuda())[0].cpu(), dec["cpu"](lat)[0]
        errs["encodec decode"] = voc_err(got, ref)
        tols = {"mel": FEAT_MEL_ATOL, "ppg": FEAT_RTOL_OF_PEAK, "encodec": FEAT_RTOL_OF_PEAK,
                "encodec decode": FEAT_RTOL_OF_PEAK}
        ok = all(errs[k] <= tols[k] for k in errs)
        log(f"feat float32 card vs CPU at {FEAT_TIMED[0]} s: log-mel max abs err "
            f"{errs['mel']:.2e} (atol {FEAT_MEL_ATOL}); PPG {errs['ppg']:.2e}, EnCodec "
            f"embeddings {errs['encodec']:.2e}, EnCodec waveform {errs['encodec decode']:.2e} "
            f"of the peak (tol {FEAT_RTOL_OF_PEAK}): {'ok' if ok else 'FAIL'}; peak device "
            f"memory over the phase {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not ok:
            failures.append(f"feat card vs cpu: {errs}")
    return failures, launches


def optional_packages() -> str:
    """Which of the packages the JAX package's CLIs lean on import here
    (the port's CLIs use ``yaml``; HDF5 and plots only where they import)."""
    import importlib

    found = []
    for name in ("yaml", "h5py", "matplotlib", "tqdm"):
        try:
            found.append(f"{name} {importlib.import_module(name).__version__}")
        except ImportError:
            found.append(f"{name} missing")
    return ", ".join(found)


def ptxas_report(text: str):
    """(entry function, its registers line, its spill line) for each kernel
    variant in ``nvcc -Xptxas -v`` output; names demangled by ``c++filt``
    where the machine has it."""
    rows, fn, spill = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            fn, spill = line.split("'")[1], ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn:
            rows.append([fn, line.split(":", 1)[-1].strip(), spill])
            fn = None
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(out) == len(rows):
            for r, name in zip(rows, out):
                r[0] = name
    return rows


# the tensor-core kernels (by library): their bfloat16 instantiations must
# issue HMMA, their float32 ones (FMA, the card's reference path) none
TENSOR_CORE = {"rel_scores": ("rel_scores_fwd_kernel",),
               "rel_scores_bwd": ("rel_scores_bwd_kernel",),
               "rel_scores_bwd_pair": ("rel_scores_bwd_dqv_kernel", "rel_scores_bwd_dpos_kernel"),
               "rel_flash": ("rel_flash_fwd_kernel",),
               "rel_flash_bwd_dq": ("rel_flash_bwd_dq_kernel",),
               "rel_flash_bwd_dkv": ("rel_flash_bwd_dkv_kernel",),
               "rel_flash_bwd_dpos": ("rel_flash_bwd_dpos_kernel",),
               "flash": ("flash_fwd_kernel",),
               "flash_bwd": ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")}
# sources whose variants must not spill (ptxas -v)
NO_SPILL = ("rel_scores", "rel_scores_bwd", "rel_scores_bwd_pair", "flash", "flash_bwd")


def sass_hmma():
    """(rows, failures): for each kernel variant of the tensor-core sources,
    its HMMA instructions in ``cuobjdump -sass`` of the built library (names
    demangled by ``c++filt``); a bfloat16 variant without one fails, and so
    does a float32 variant with one."""
    from seq2seq_vc_torch.ops import native

    tool = shutil.which("cuobjdump") or str(Path(native._nvcc()).with_name("cuobjdump"))
    rows, failures = [], []
    for lib, kernels in TENSOR_CORE.items():
        sass = subprocess.run([tool, "-sass", str(native._library_path(lib))],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function : " in line:
                fn = line.split("Function : ", 1)[1].strip()
                counts[fn] = 0
            elif fn is not None and "HMMA" in line:
                counts[fn] += 1
        names = list(counts)
        if shutil.which("c++filt"):
            out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                                 text=True, timeout=60).stdout.splitlines()
            names = out if len(out) == len(names) else names
        for name, n in zip(names, counts.values()):
            name = name[:name.rfind(">") + 1] or name  # the variant, without its parameters
            rows.append((lib, name, n))
            if any(k in name for k in kernels):
                if "bfloat16" in name and n == 0:
                    failures.append(f"sass {lib}: {name} issues no HMMA")
                if "bfloat16" not in name and n > 0:
                    failures.append(f"sass {lib}: float32 variant {name} issues HMMA")
        for kernel in kernels:
            if not any(kernel in name and "bfloat16" in name for name in names):
                failures.append(f"sass {lib}: no bfloat16 variant of {kernel} found")
    return rows, failures


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, str(REPO))
    from seq2seq_vc_torch.ops import native

    sweeps = {"--bwd-sweep": bwd_sweep, "--flash-sweep": flash_sweep}
    if sys.argv[1:2] and sys.argv[1] in sweeps:
        native.build()
        return sweeps[sys.argv[1]]()
    from seq2seq_vc_torch.pipeline import Wav2WavConverter

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"tf32: torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    log(f"packages: {optional_packages()}")

    t0 = time.perf_counter()
    built = native.build(verbose=True)
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(built)} "
        f"(per kernel: { {k: round(v['seconds'], 1) for k, v in built.items()} })")
    spills = []
    for name, res in built.items():
        for fn, regs, spill in ptxas_report(res["log"]):
            log(f"  ptxas {name}: {fn}: {regs}; {spill}")
            if name in NO_SPILL and any(int(n) for n in re.findall(r"(\d+) bytes spill", spill)):
                spills.append(f"ptxas {name}: {fn} spills: {spill}")
    sass_rows, failures = sass_hmma()
    failures += spills
    for lib, fn, n in sass_rows:
        log(f"  sass {lib}: {fn}: {n} HMMA")

    with torch.no_grad():
        model, vocoder = build_models(seed=0)
        src, trg = stats(1), stats(2)
        conv = Wav2WavConverter(model, vocoder, src, trg, FEATS)  # on the card
        requests = serving_requests()
        log("warm-up: each request once, then the synthesis ladder")
        fails, warm = serve(conv, requests)
        failures += fails
        log(f"warm-up synthesis buckets: {conv.warmup_synth()}")
        calls = planned_calls(conv, requests, [r["out_frames"] for r in warm])
        expected = {n: sum(c[0] == n for c in calls) for n in KERNELS}

        rows = []
        for name in PATH_KERNELS["serve"]:
            for D, T in ((192, 640), (768, 1300)):
                for dtype in (torch.float32, torch.bfloat16):
                    rows.append(check_kernel(name, 2, 2, T, D, dtype, seed=T + D, label="head-dim"))
            for B, H, T, D, lens in sorted({c[1:] for c in calls if c[0] == name}):
                rows.append(check_kernel(name, B, H, T, D, torch.bfloat16, seed=T,
                                         label="main-path", lens=lens))

        log("main path: the same requests again")
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        fails, timed = serve(conv, requests)
        launches = {"serve": launch_counts()}
        failures += fails
        log(f"main path launches {launches['serve']}, expected from the routing {expected}; "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for name in KERNELS:
            got = launches["serve"][name]
            if got != expected[name] or (got == 0 and name in PATH_KERNELS["serve"]):
                failures.append(f"{name}: {got} launches, expected {expected[name]}")

        failures += reference_check(model, vocoder, src, trg)
        profile_request(conv, requests[-1], timed[-1]["ms"])
        del conv, model, vocoder

    fails, launches["train"] = train_path(rows)
    failures += fails
    torch.cuda.empty_cache()
    fails, launches["train_long"] = train_long_path(rows)
    failures += fails
    torch.cuda.empty_cache()
    fails, launches["vtn_serve"] = vtn_serve_path(rows, src, trg)
    failures += fails
    for path in ("vtn_train", "vtn_train_long"):
        torch.cuda.empty_cache()
        fails, launches[path] = vtn_train_path(rows, path)
        failures += fails
    failures += vtn_reference_step(seed=34)
    phases = (("legacy_serve", lambda: legacy_serve_path(rows, src, trg)),
              ("train_long_legacy", lambda: train_long_path(rows, "train_long_legacy")),
              ("train_pallas", lambda: train_pallas_path(rows)))
    for path, run in phases:
        torch.cuda.empty_cache()
        t_phase = time.perf_counter()
        fails, launches[path] = run()
        failures += fails
        log(f"phase {path}: {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    fails, cli = cli_path(rows)
    failures += fails
    launches.update(cli)
    log(f"phase cli: {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    fails, fs2 = fs2_path(rows, src, trg)
    failures += fails
    launches.update(fs2)
    log(f"phase fs2: {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    fails, tts = tts_path(rows)
    failures += fails
    launches.update(tts)
    log(f"phase tts: {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    fails, voc = vocoder_path(rows)
    failures += fails
    launches.update(voc)
    log(f"phase voc: {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    fails, feat = feature_path(rows)
    failures += fails
    launches.update(feat)
    log(f"phase feat: {time.perf_counter() - t_phase:.1f} s")
    failures += [f"check {r['name']} {r['shape']} {r['dtype']}: err {r['max_abs_err']}"
                 for r in rows if not r["ok"]]

    table = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["name"] == name]
        main_rows = [r for r in mine if r["label"] == "main-path"]
        top = max(main_rows, key=lambda r: r["shape"][0] * r["shape"][2] ** 2 * r["shape"][3])
        rate0 = [r for r in mine if r["label"] == "rate-0" and r["shape"] == top["shape"]]
        by_path = {path: counts[name] for path, counts in launches.items()}
        table.append(dict(
            name=name, **meta, launches=sum(by_path.values()),
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=top["library_ms"],
            library_bwd_ms=top.get("library_bwd_ms"), half_work_ms=top.get("half_work_ms"),
            ms_rate_0=rate0[0]["ms"] if rate0 else None, rate=top["rate"],
            library=LIBRARY[name], launches_by_path=by_path,
            shape_bhtd=list(top["shape"]), kv_lens=top["kv_lens"], dtype=top["dtype"],
        ))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": table}))
    log(card)  # nvidia-smi's name and power limit, as it gives them
    if failures:
        for f in failures:
            print(f"FAIL {f}", file=sys.stderr)
        return 1
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
