"""Vocoder wrapper: the feature de/re-normalisation chain and synthesis
(mirrors seq2seq_vc_tpu/vocoder/vocoder.py:30-139).

The VC model emits features normalised by the target speaker's stats; a
vocoder trained with stats of its own gets them de-normalised by the
target's and re-normalised by its own before synthesis. ``get_vocoder``
reads a training config: its ``vocoder:`` block names a HiFi-GAN in the
port's checkpoint format (``checkpoint``, optional ``config`` and
``stats``); without the block, Griffin-Lim. The JAX package's other
backends are not ported yet.
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
from .griffin_lim import Spectrogram2Waveform
from .hifigan import chunked_generate, load_hifigan_model

_NOT_PORTED = "is not ported yet: ROADMAP.md queue 1 item 5 (the rest: vocoders)"


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


def hifigan_backend(checkpoint: str, config_path: Optional[str] = None, device=None):
    """(T, in_channels) features -> (N,) waveform through chunked HiFi-GAN
    synthesis on ``device`` (default: the card)."""
    device = resolve_device(device)
    model = load_hifigan_model(checkpoint, config_path, device=device)

    @torch.no_grad()
    def backend(feats: np.ndarray) -> np.ndarray:
        mel = torch.as_tensor(feats, dtype=torch.float32, device=device)
        return chunked_generate(model, mel).cpu().numpy()

    return backend


def get_vocoder(config: Dict[str, Any], trg_stats=None, device=None) -> Vocoder:
    """The vocoder of a training config (its ``vocoder:`` block, or
    Griffin-Lim), synthesising on ``device`` (default: the card)."""
    device = resolve_device(device)
    fs = config.get("sampling_rate", 16000)
    voc_cfg = config.get("vocoder") or {}
    voc_type = voc_cfg.get("vocoder_type", "")
    if voc_type in ("encodec", "s3prl_vc"):
        raise NotImplementedError(f"vocoder_type {voc_type!r} {_NOT_PORTED}")
    if voc_cfg.get("checkpoint"):
        if voc_cfg.get("config"):  # a parallel_wavegan config names its generator
            gen_type = load_config(voc_cfg["config"]).get("generator_type",
                                                          "ParallelWaveGANGenerator")
            if gen_type != "HifiganGenerator":
                raise NotImplementedError(f"generator_type {gen_type!r} {_NOT_PORTED}")
        vocoder_stats = read_stats(voc_cfg["stats"]) if voc_cfg.get("stats") else None
        backend = hifigan_backend(voc_cfg["checkpoint"], voc_cfg.get("config"), device)
        return Vocoder(backend, fs, trg_stats, vocoder_stats)
    backend = Spectrogram2Waveform(
        fs=fs, n_fft=config.get("fft_size", 1024), n_shift=config.get("hop_size", 256),
        n_mels=config.get("num_mels", 80), win_length=config.get("win_length"),
        window=config.get("window", "hann"), fmin=config.get("fmin"), fmax=config.get("fmax"),
        griffin_lim_iters=config.get("griffin_lim_iters", 32), device=device,
    )
    return Vocoder(backend, fs, trg_stats, None)
