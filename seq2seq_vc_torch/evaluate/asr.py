"""ASR-based intelligibility metrics (mirrors seq2seq_vc_tpu/evaluate/asr.py,
the reference's ``evaluate/asr.py``).

Transcription runs the port's own wav2vec2 for CTC (``evaluate/wav2vec2.py``)
from a local Hugging Face model directory, on the card unless the caller
asks for the CPU; it needs no ``transformers`` and never a hub name.
``levenshtein``, ``normalize_text`` and the error rates are copies of the
JAX package's (a native Levenshtein in place of jiwer, the same
normalisation: upper case, punctuation stripped).
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np
import torch

from ..urhythmic.hubert import conv_frames
from .wav2vec2 import Processor, load_wav2vec2


def levenshtein(a: List, b: List) -> int:
    """Edit distance between two token sequences."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def normalize_text(text: str) -> str:
    text = text.upper()
    text = re.sub(r"[^A-Z' ]", "", text)
    return re.sub(r"\s+", " ", text).strip()


def character_error_rate(hyp: str, ref: str) -> float:
    hyp, ref = normalize_text(hyp).replace(" ", ""), normalize_text(ref).replace(" ", "")
    if not ref:
        return 0.0 if not hyp else 1.0
    return levenshtein(list(hyp), list(ref)) / len(ref)


def word_error_rate(hyp: str, ref: str) -> float:
    hyp_w, ref_w = normalize_text(hyp).split(), normalize_text(ref).split()
    if not ref_w:
        return 0.0 if not hyp_w else 1.0
    return levenshtein(hyp_w, ref_w) / len(ref_w)


class ASRTranscriber:
    """wav2vec2-CTC transcriber (the reference runs
    facebook/wav2vec2-large-960h-lv60-self). ``model_path`` is a local
    model directory; ``model``/``processor`` may be given instead (a
    ``Wav2Vec2ForCTC`` and a ``Processor``).

    As the JAX package's flax path: the normalised samples are zero-padded
    to a multiple of ``BUCKET_SAMPLES`` (1 s) and the model runs masked, so
    the set of shapes stays small and the valid frames equal the
    exact-length forward's; the argmax is read over the valid frames, their
    count from the conv arithmetic."""

    BUCKET_SAMPLES = 16000

    def __init__(self, model_path: Optional[str] = None, device=None, model=None,
                 processor=None):
        if model is None:
            model = load_wav2vec2(model_path, device)
        self.model = model
        self.processor = processor if processor is not None else Processor(model_path)
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def logits(self, audio, sr: int = 16000) -> torch.Tensor:
        """The float32 logits (frames, vocab) of one utterance's valid
        frames, on the model's device."""
        x = self.processor.normalize(audio, sr)
        n = len(x)
        padded = np.zeros((1, -(-n // self.BUCKET_SAMPLES) * self.BUCKET_SAMPLES), np.float32)
        padded[0, :n] = x
        logits, _ = self.model(torch.from_numpy(padded).to(self.device),
                               torch.tensor([n], device=self.device))
        cfg = self.model.config
        return logits[0, : conv_frames(n, cfg["conv_kernel"], cfg["conv_stride"])]

    def transcribe(self, audio, sr: int = 16000) -> str:
        return self.processor.decode(self.logits(audio, sr).argmax(-1).tolist())
