"""STFT helpers (mirrors seq2seq_vc_tpu/dsp/stft.py)."""

from __future__ import annotations

import numpy as np
import torch


def hann_window(win_length: int, n_fft: int | None = None, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window of ``win_length``, zero-padded centred to ``n_fft``."""
    n = np.arange(win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    if n_fft is not None and n_fft > win_length:
        pad = (n_fft - win_length) // 2
        w = np.pad(w, (pad, n_fft - win_length - pad))
    return w.astype(dtype)


def num_frames(n_samples: int, hop_size: int) -> int:
    """Frame count for a centred STFT (librosa: ``1 + n_samples // hop``)."""
    return 1 + n_samples // hop_size


def reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """``x`` reflect-padded along its last axis as ``np.pad(mode="reflect")``
    pads, pads longer than the axis included (the periodic extension of
    period 2 (N - 1); a single sample repeats)."""
    n = x.shape[-1]
    idx = torch.arange(-left, n + right, device=x.device)
    if n == 1:
        return x[..., torch.zeros_like(idx)]
    idx = idx.abs() % (2 * (n - 1))
    return x[..., torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)]
