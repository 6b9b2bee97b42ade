"""Log-mel features (mirrors seq2seq_vc_tpu/dsp/features.py: ``_logmel``,
:25, and ``logmelfilterbank``)."""

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


def logmelfilterbank(audio: np.ndarray, sampling_rate: int, fft_size: int = 1024,
                     hop_size: int = 256, win_length: Optional[int] = None,
                     window: str = "hann", num_mels: int = 80, fmin: Optional[float] = None,
                     fmax: Optional[float] = None, log_base: Optional[float] = 10.0,
                     device=None) -> np.ndarray:
    """One utterance (T,) -> (1 + T // hop_size, num_mels) float32 log-mel:
    reflect-padded centred STFT, Slaney mel basis, ``max(1e-10, .)``, on
    ``device`` (default: the card)."""
    device = resolve_device(device)
    if window != "hann":
        raise ValueError(f"unsupported window: {window}")
    pad = fft_size // 2
    x = np.pad(np.asarray(audio, np.float32), (pad, pad), mode="reflect")
    w = hann_window(win_length or fft_size, fft_size)
    mel_t = mel_filterbank(sampling_rate, fft_size, num_mels, fmin or 0,
                           sampling_rate / 2 if fmax is None else fmax).T
    with torch.no_grad():
        mel = _logmel(torch.as_tensor(x, device=device), torch.as_tensor(w, device=device),
                      torch.as_tensor(mel_t, device=device), fft_size, hop_size, log_base)
    return mel.cpu().numpy()
