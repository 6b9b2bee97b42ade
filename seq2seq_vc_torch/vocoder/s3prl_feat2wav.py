"""Two-stage latent -> waveform vocoding (mirrors
seq2seq_vc_tpu/vocoder/s3prl_feat2wav.py:26-79).

Stage 1 maps upstream latents (e.g. s3prl PPGs) to mel with the Taco2-AR
downstream (``taco2ar.build_downstream``); stage 2 vocodes the mel with
the inner vocoder. Incoming latents are de-normalised with the VC model's
target stats; the downstream returns mel in the inner vocoder's domain,
and the inner vocoder runs its own chain (``Vocoder.decode``).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from ..dsp.stats import denormalize


class S3PRLFeat2Wav:
    def __init__(self, downstream: Callable[[np.ndarray], np.ndarray], inner_vocoder,
                 trg_stats: Optional[Dict[str, np.ndarray]] = None):
        """``downstream``: (T, latent_dim) -> (T', n_mels); ``inner_vocoder``:
        a ``Vocoder`` of that mel; ``trg_stats``: {"mean", "scale"} of the
        VC model's target latents."""
        self.downstream = downstream
        self.inner = inner_vocoder
        self.trg_stats = trg_stats

    @classmethod
    def from_checkpoint(cls, checkpoint: str, config: Dict[str, Any],
                        stats: Dict[str, np.ndarray], trg_stats, inner_vocoder,
                        device=None) -> "S3PRLFeat2Wav":
        """An s3prl-vc downstream checkpoint, its config and mel stats, the
        VC target stats and the inner vocoder, on ``device`` (default: the
        card)."""
        from .taco2ar import build_downstream

        downstream = build_downstream(checkpoint, config, stats["mean"], stats["scale"],
                                      device)
        return cls(downstream, inner_vocoder, trg_stats)

    @property
    def fs(self) -> int:
        return self.inner.fs

    def decode(self, latents: np.ndarray) -> np.ndarray:
        start = time.perf_counter()
        if self.trg_stats is not None:
            latents = denormalize(latents, self.trg_stats["mean"], self.trg_stats["scale"])
        y = self.inner.decode(np.asarray(self.downstream(latents)))
        logging.info("feat2wav total RTF = %.06f",
                     (time.perf_counter() - start) / (len(y) / self.fs))
        return y
