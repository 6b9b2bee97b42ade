"""The EnCodec vocoder: converted continuous latents -> 24 kHz waveform
(mirrors seq2seq_vc_tpu/vocoder/encodec_dec.py).

``get_vocoder`` routes ``vocoder_type: encodec`` here: ``Vocoder`` undoes
the VC targets' normalisation, then the SEANet decoder synthesises. The
latents are zero-padded to a multiple of ``DECODE_BUCKET`` frames, as the
JAX decoder pads them, and the waveform is trimmed to 320 samples a frame;
the decoder is causal, so the kept samples see none of the padding.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..encoders.encodec import DECODE_BUCKET, HOP, load_encodec_decoder


def encodec_backend(checkpoint: str, device=None) -> Callable[[np.ndarray], np.ndarray]:
    """(T, 128) latents -> (T * 320,) waveform through the decoder of a
    torch EnCodec checkpoint on ``device`` (default: the card)."""
    model = load_encodec_decoder(checkpoint, device)
    dev = next(model.parameters()).device

    @torch.no_grad()
    def backend(latents: np.ndarray) -> np.ndarray:
        t = len(latents)
        x = torch.as_tensor(np.asarray(latents, np.float32), device=dev)
        x = F.pad(x, (0, 0, 0, -t % DECODE_BUCKET))
        return model(x[None])[0, : t * HOP].cpu().numpy()

    return backend
