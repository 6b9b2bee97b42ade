"""Log-mel features (mirrors seq2seq_vc_tpu/dsp/features.py:25)."""

from __future__ import annotations

import torch


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
