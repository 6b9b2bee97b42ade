"""Urhythmic conversion systems (mirrors seq2seq_vc_tpu/urhythmic/model.py):
segmentation -> rhythm transform -> time stretch -> HiFi-GAN synthesis.

Segmentation, the rhythm models and the stretchers run on the host in
numpy; the encoder and the vocoder on their device.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .hubert import HubertSoft, encode_batch
from .segmenter import Segmenter


def encode(hubert: Any, wav: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """wav -> (soft units (N, D), log_probs (N, K)) through ``hubert``: the
    port's ``HubertSoft`` (bucket-padded and masked, as ``encode_batch``),
    or any torch module with ``units(wav)`` and ``logits(units)`` (e.g.
    bshall/hubert from torch hub), on its device. Raises for None."""
    if hubert is None:
        raise RuntimeError("a HuBERT-soft encoder is required: load a checkpoint with "
                           "urhythmic.hubert.load_hubert_soft, or pass a torch module")
    if isinstance(hubert, HubertSoft):
        units, log_probs, n_frames = encode_batch(hubert, wav)
        n = int(n_frames[0])
        return units[0, :n].cpu().numpy(), log_probs[0, :n].cpu().numpy()
    device = next(hubert.parameters()).device
    with torch.inference_mode():
        t = torch.as_tensor(np.asarray(wav), dtype=torch.float32, device=device).reshape(1, 1, -1)
        units = hubert.units(t)
        log_probs = F.log_softmax(hubert.logits(units), dim=-1)
    return units[0].cpu().numpy(), log_probs[0].cpu().numpy()


class _UrhythmicBase:
    def __init__(self, segmenter: Segmenter, rhythm_model, time_stretcher, vocoder_fn):
        """vocoder_fn: callable (T, D) units -> (N,) waveform (see
        ``vocoder.hifigan.load_hifigan_backend``)."""
        self.segmenter = segmenter
        self.rhythm_model = rhythm_model
        self.time_stretcher = time_stretcher
        self.vocoder_fn = vocoder_fn


class UrhythmicFine(_UrhythmicBase):
    """Fine-grained voice + rhythm conversion."""

    def __call__(self, units: np.ndarray, log_probs: np.ndarray) -> np.ndarray:
        """units: (N, D); log_probs: (N, K). Returns waveform (T,)."""
        clusters, boundaries = self.segmenter(log_probs)
        tgt_durations = self.rhythm_model(clusters, boundaries)
        stretched = self.time_stretcher(units, clusters, boundaries, tgt_durations)
        return np.asarray(self.vocoder_fn(stretched))


class UrhythmicGlobal(_UrhythmicBase):
    """Global speaking-rate conversion."""

    def __call__(self, units: np.ndarray, log_probs: np.ndarray) -> np.ndarray:
        ratio = self.rhythm_model()
        stretched = self.time_stretcher(units, ratio)
        return np.asarray(self.vocoder_fn(stretched))
