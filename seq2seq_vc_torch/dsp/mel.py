"""Slaney mel filterbank, area-normalised (mirrors seq2seq_vc_tpu/dsp/mel.py;
equivalent to ``librosa.filters.mel(htk=False, norm="slaney")``)."""

from __future__ import annotations

import numpy as np

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq):
    """Slaney hz->mel: linear below 1 kHz, log above."""
    freq = np.asarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    safe = np.where(log_region, freq, _MIN_LOG_HZ)
    return np.where(log_region, _MIN_LOG_MEL + np.log(safe / _MIN_LOG_HZ) / _LOGSTEP, mels)


def mel_to_hz(mels):
    """Slaney mel->hz inverse."""
    mels = np.asarray(mels, dtype=np.float64)
    freqs = mels * _F_SP
    log_region = mels >= _MIN_LOG_MEL
    return np.where(
        log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)), freqs
    )


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 80, fmin: float = 0.0,
                   fmax: float | None = None, dtype=np.float32) -> np.ndarray:
    """Triangular mel filterbank matrix of shape (n_mels, 1 + n_fft // 2)."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels])
    return (weights * enorm[:, None]).astype(dtype)
