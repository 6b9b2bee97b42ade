"""Griffin-Lim vocoder (mirrors seq2seq_vc_tpu/vocoder/griffin_lim.py):
log-mel -> pseudo-inverse mel -> linear magnitude -> iterative phase
recovery, in plain PyTorch (``torch.stft`` / ``torch.istft``) on the
caller's device. There is no kernel behind it.

The JAX function draws its initial phases from ``jax.random.uniform``;
here they come from ``angles`` when given (uniform numbers in [0, 1),
one per spectrogram cell) or else from an explicit CPU generator, so the
same numbers reach either device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..dsp.mel import mel_filterbank
from ..dsp.stft import hann_window

EPS = 1e-10


def logmel2linear(lmspc: np.ndarray, fs: int, n_fft: int, n_mels: int,
                  fmin: Optional[float] = None, fmax: Optional[float] = None) -> np.ndarray:
    """Log10-mel (T, n_mels) -> linear magnitude spectrogram (T, n_fft//2+1)."""
    fmin = 0 if fmin is None else fmin
    fmax = fs / 2 if fmax is None else fmax
    mspc = np.power(10.0, np.asarray(lmspc, np.float64))
    inv_mel_basis = np.linalg.pinv(mel_filterbank(fs, n_fft, n_mels, fmin, fmax, dtype=np.float64))
    return np.maximum(EPS, (inv_mel_basis @ mspc.T).T).astype(np.float32)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """numpy's (and the JAX package's) ``reflect`` padding of a 1-D signal
    by ``pad`` on each side, which also reflects again where ``pad`` is not
    shorter than the signal (torch's reflect padding raises there: a
    decode of one or two frames)."""
    n = x.shape[-1]
    pos = torch.arange(-pad, n + pad, device=x.device)
    if n == 1:
        return x[..., torch.zeros_like(pos)]
    period = 2 * (n - 1)
    m = pos.remainder(period)
    return x[..., torch.where(m < n, m, period - m)]


def griffin_lim(spc: np.ndarray, n_fft: int, n_shift: int, win_length: Optional[int] = None,
                window: str = "hann", n_iter: int = 32, angles: Optional[np.ndarray] = None,
                generator: Optional[torch.Generator] = None, device=None) -> np.ndarray:
    """Linear magnitude spectrogram (T, n_fft//2+1) -> waveform (T * n_shift,).

    The initial phase of each cell is ``2 pi angles``; ``angles`` defaults
    to uniform draws of ``generator`` (a CPU generator). Runs on ``device``
    (default: the card)."""
    device = resolve_device(device)
    if window != "hann":
        raise ValueError(f"unsupported window: {window}")
    if spc.shape[1] != n_fft // 2 + 1:
        raise ValueError(f"spc has {spc.shape[1]} bins, n_fft {n_fft} gives {n_fft // 2 + 1}")
    n_frames = spc.shape[0]
    length = n_shift * n_frames
    if angles is None:
        angles = torch.rand(spc.shape, generator=generator)
    mag = torch.as_tensor(np.asarray(spc, np.float32), device=device).T  # (F, T)
    angles = torch.tensor(np.asarray(angles, np.float32), device=device).T
    phase = torch.polar(torch.ones_like(mag), 2 * math.pi * angles)
    w = torch.as_tensor(hann_window(win_length or n_fft, n_fft), device=device)

    def istft(s):
        return torch.istft(s, n_fft, n_shift, window=w, center=True, length=length)

    for _ in range(n_iter):
        s = torch.stft(reflect_pad(istft(mag * phase), n_fft // 2), n_fft, n_shift, window=w,
                       center=False, return_complex=True)[:, :n_frames]
        phase = torch.polar(torch.ones_like(mag), torch.angle(s))
    return istft(mag * phase).cpu().numpy()


class Spectrogram2Waveform:
    """Log-mel (or linear magnitude, without ``n_mels``) -> waveform. Each
    call draws its initial phases from a CPU generator seeded ``seed``, and
    runs on ``device`` (default: the card)."""

    def __init__(self, fs: int, n_fft: int, n_shift: int, n_mels: Optional[int] = None,
                 win_length: Optional[int] = None, window: str = "hann",
                 fmin: Optional[float] = None, fmax: Optional[float] = None,
                 griffin_lim_iters: int = 32, seed: int = 0, device=None):
        self.fs = fs
        self.n_fft, self.n_shift, self.n_mels = n_fft, n_shift, n_mels
        self.win_length, self.window = win_length, window
        self.fmin, self.fmax = fmin, fmax
        self.n_iter = griffin_lim_iters
        self.seed = seed
        self.device = resolve_device(device)

    def __call__(self, spc: np.ndarray) -> np.ndarray:
        if self.n_mels is not None:
            spc = logmel2linear(spc, self.fs, self.n_fft, self.n_mels, self.fmin, self.fmax)
        return griffin_lim(spc, self.n_fft, self.n_shift, self.win_length, self.window,
                           self.n_iter, generator=torch.Generator().manual_seed(self.seed),
                           device=self.device)
