"""Log-mel features (mirrors seq2seq_vc_tpu/dsp/features.py: ``_logmel``,
:25, ``LogMelExtractor`` and ``logmelfilterbank``)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .mel import mel_filterbank
from .stft import hann_window


def _logmel(x: torch.Tensor, window: torch.Tensor, mel_basis_t: torch.Tensor,
            fft_size: int, hop_size: int, log_base=10.0) -> torch.Tensor:
    """Log-mel of host-reflect-padded audio.

    x: (..., N) centred-reflect-padded waveform; returns (..., frames, n_mels)
    with frames = 1 + (N - fft_size) // hop_size.
    """
    frames = x.unfold(-1, fft_size, hop_size) * window
    spc = torch.fft.rfft(frames, dim=-1).abs()
    mel = torch.clamp(spc @ mel_basis_t, min=1e-10)
    if log_base is None:
        return torch.log(mel)
    if log_base == 10.0:
        return torch.log10(mel)
    if log_base == 2.0:
        return torch.log2(mel)
    raise ValueError(f"{log_base} is not supported.")


class LogMelExtractor:
    """wav -> log-mel for one run (seq2seq_vc_tpu/dsp/features.py:42-90):
    the Hann window and the Slaney basis are made once and stay on
    ``device`` (default: the card). Each call reflect-pads the utterance on
    the host and takes exactly ``num_frames(len, hop)`` frames. The JAX
    extractor pads the audio to length buckets so that ``jit`` compiles once
    a bucket; torch runs each length as it comes without compiling, so this
    one takes the exact length (the frames are the same: the bucket's zeros
    lie past the last one)."""

    def __init__(self, sampling_rate: int, fft_size: int = 1024, hop_size: int = 256,
                 win_length: Optional[int] = None, window: str = "hann", num_mels: int = 80,
                 fmin: Optional[float] = None, fmax: Optional[float] = None,
                 log_base: Optional[float] = 10.0, device=None):
        if window != "hann":
            raise ValueError(f"unsupported window: {window}")
        self.device = resolve_device(device)
        self.fft_size, self.hop_size, self.log_base = fft_size, hop_size, log_base
        w = hann_window(win_length or fft_size, fft_size)
        mel_t = mel_filterbank(sampling_rate, fft_size, num_mels, fmin or 0,
                               sampling_rate / 2 if fmax is None else fmax).T
        self._window = torch.as_tensor(w, device=self.device)
        self._mel_t = torch.as_tensor(mel_t, device=self.device)

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        """(T,) audio -> (1 + T // hop_size, num_mels) float32 log-mel."""
        pad = self.fft_size // 2
        x = np.pad(np.asarray(audio, np.float32), (pad, pad), mode="reflect")
        with torch.no_grad():
            mel = _logmel(torch.as_tensor(x, device=self.device), self._window, self._mel_t,
                          self.fft_size, self.hop_size, self.log_base)
        return mel.cpu().numpy()


def logmelfilterbank(audio: np.ndarray, sampling_rate: int, fft_size: int = 1024,
                     hop_size: int = 256, win_length: Optional[int] = None,
                     window: str = "hann", num_mels: int = 80, fmin: Optional[float] = None,
                     fmax: Optional[float] = None, log_base: Optional[float] = 10.0,
                     device=None) -> np.ndarray:
    """One utterance (T,) -> (1 + T // hop_size, num_mels) float32 log-mel
    through a ``LogMelExtractor`` made for it, on ``device`` (default: the
    card)."""
    return LogMelExtractor(sampling_rate, fft_size, hop_size, win_length, window, num_mels,
                           fmin, fmax, log_base, device)(audio)
