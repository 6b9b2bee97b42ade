"""Vocoder wrapper: the feature de/re-normalisation chain and synthesis
(mirrors seq2seq_vc_tpu/vocoder/vocoder.py:30-139).

The VC model emits features normalised by the target speaker's stats; a
vocoder trained with stats of its own gets them de-normalised by the
target's and re-normalised by its own before synthesis. ``get_vocoder``
reads a training config: its ``vocoder:`` block names a checkpoint,
optional ``config`` and ``stats``, routed in the JAX package's order by
the config's ``generator_type``: ParallelWaveGAN (``pwg.py``), StyleMelGAN
and MelGAN (``melgan.py``) in ``parallel_wavegan``'s checkpoint layout,
else HiFi-GAN in the port's format (``hifigan.py``); ``vocoder_type:
s3prl_vc`` is the two-stage Taco2-AR vocoder (``s3prl_feat2wav.py``),
whose downstream config's own ``vocoder:`` block builds the inner
vocoder; ``vocoder_type: encodec`` is EnCodec's SEANet decoder over
continuous latents (``encodec_dec.py``, 24 kHz). Without the block,
Griffin-Lim.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core.config import load_config
from ..device import resolve_device
from ..dsp.stats import denormalize, normalize
from ..utils.io import read_stats
from ..encoders.encodec import SAMPLE_RATE as ENCODEC_FS
from .encodec_dec import encodec_backend
from .griffin_lim import Spectrogram2Waveform
from .hifigan import load_hifigan_backend
from .melgan import load_melgan_model
from .pwg import load_pwg_model
from .s3prl_feat2wav import S3PRLFeat2Wav

BUCKET_FRAMES = 64  # the JAX backends' bucket: features edge-pad to a multiple of it
NOISE_SEED = 0  # the generators' noise, seeded on every call as in the JAX backends


class Vocoder:
    def __init__(self, backend: Callable[[np.ndarray], np.ndarray], fs: int,
                 trg_stats: Optional[Dict[str, np.ndarray]] = None,
                 vocoder_stats: Optional[Dict[str, np.ndarray]] = None):
        """``backend``: (T, odim) features -> (N,) waveform; ``trg_stats``
        and ``vocoder_stats``: {"mean", "scale"} of the VC targets and of
        the vocoder's training features."""
        self.backend = backend
        self.fs = fs
        self.trg_stats = trg_stats
        self.vocoder_stats = vocoder_stats

    def decode(self, feats: np.ndarray) -> np.ndarray:
        if self.trg_stats is not None:
            feats = denormalize(feats, self.trg_stats["mean"], self.trg_stats["scale"])
        if self.vocoder_stats is not None:
            feats = normalize(feats, self.vocoder_stats["mean"], self.vocoder_stats["scale"])
        start = time.perf_counter()
        y = np.asarray(self.backend(np.asarray(feats, np.float32)))
        logging.info("vocoder RTF = %.06f", (time.perf_counter() - start) / (len(y) / self.fs))
        return y


def generator_backend(model: torch.nn.Module):
    """(T, aux) features -> (T * hop,) waveform through a ``parallel_wavegan``
    generator (PWG, MelGAN, StyleMelGAN) on its device: the frames
    edge-padded to a multiple of ``BUCKET_FRAMES``, as the JAX backends pad
    them (so the waveform's tail matches theirs), the waveform trimmed back,
    the noise from a CPU generator seeded with ``NOISE_SEED`` on every call,
    so a call repeats itself."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def backend(feats: np.ndarray) -> np.ndarray:
        t = len(feats)
        pad = -(-t // BUCKET_FRAMES) * BUCKET_FRAMES - t
        c = np.pad(np.asarray(feats, np.float32), ((0, pad), (0, 0)), mode="edge")
        y = model(torch.as_tensor(c, device=device)[None],
                  generator=torch.Generator().manual_seed(NOISE_SEED))
        return y[0, : t * model.hop].cpu().numpy()

    return backend


def get_vocoder(config: Dict[str, Any], trg_stats=None, device=None) -> Vocoder:
    """The vocoder of a training config (its ``vocoder:`` block, or
    Griffin-Lim), synthesising on ``device`` (default: the card)."""
    device = resolve_device(device)
    fs = config.get("sampling_rate", 16000)
    voc_cfg = config.get("vocoder") or {}
    voc_type = voc_cfg.get("vocoder_type", "")
    if voc_type == "encodec":
        if not voc_cfg.get("checkpoint"):
            raise ValueError("vocoder_type 'encodec' needs `checkpoint:` (a torch EnCodec "
                             "state_dict, HF transformers or facebookresearch naming)")
        return Vocoder(encodec_backend(voc_cfg["checkpoint"], device), ENCODEC_FS, trg_stats)
    if voc_type == "s3prl_vc":
        ds_cfg = load_config(voc_cfg["config"])
        inner = get_vocoder(ds_cfg, None, device)
        return S3PRLFeat2Wav.from_checkpoint(voc_cfg["checkpoint"], ds_cfg,
                                             read_stats(voc_cfg["stats"]), trg_stats, inner,
                                             device)
    if voc_cfg.get("checkpoint"):
        ckpt, gen_cfg = voc_cfg["checkpoint"], voc_cfg.get("config")
        gen_type = "HifiganGenerator"
        if gen_cfg:  # a parallel_wavegan config names its generator
            gen_type = load_config(gen_cfg).get("generator_type", "ParallelWaveGANGenerator")
        if "ParallelWaveGAN" in gen_type:
            backend = generator_backend(load_pwg_model(ckpt, gen_cfg, device))
        elif "MelGAN" in gen_type:  # StyleMelGAN or MelGAN
            backend = generator_backend(load_melgan_model(ckpt, gen_cfg, device,
                                                          style="StyleMelGAN" in gen_type))
        else:
            backend = load_hifigan_backend(ckpt, gen_cfg, device)
        vocoder_stats = read_stats(voc_cfg["stats"]) if voc_cfg.get("stats") else None
        return Vocoder(backend, fs, trg_stats, vocoder_stats)
    backend = Spectrogram2Waveform(
        fs=fs, n_fft=config.get("fft_size", 1024), n_shift=config.get("hop_size", 256),
        n_mels=config.get("num_mels", 80), win_length=config.get("win_length"),
        window=config.get("window", "hann"), fmin=config.get("fmin"), fmax=config.get("fmax"),
        griffin_lim_iters=config.get("griffin_lim_iters", 32), device=device,
    )
    return Vocoder(backend, fs, trg_stats, None)
