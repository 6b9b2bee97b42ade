"""Signal analysis for objective evaluation.

A copy of seq2seq_vc_tpu/evaluate/signal.py (host numpy there too), so
that the PyTorch port needs nothing of the JAX package.

Native replacement for reference ``utils/signal.py`` (which uses
pyworld/pysptk, not dependencies of the package): STFT power spectral
envelope at a 5 ms shift, mel-cepstral analysis via real cepstrum + SPTK ``freqt`` frequency
warping (all-pass alpha), normalized power (npow) VAD, and autocorrelation
F0. If pyworld/pysptk ARE importable, ``world_extract`` uses them for exact
parity with the reference; otherwise the native chain is used: the
CheapTrick port below plus the Harvest port in ``evaluate/harvest.py``
(``acf_f0`` remains as a lighter RAPT-style alternative).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.signal import firwin, lfilter

MCEP_DIM = 39
MCEP_ALPHA = 0.466
MCEP_SHIFT = 5  # ms
MCEP_FFTL = 1024


def low_cut_filter(x: np.ndarray, fs: int, cutoff: float = 70) -> np.ndarray:
    nyquist = fs // 2
    fil = firwin(255, cutoff / nyquist, pass_zero=False)
    return lfilter(fil, 1, x)


def freqt(ceps: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """SPTK frequency transform: warp a cepstrum onto the mel axis.

    ceps: (..., M+1) input cepstra; returns (..., order+1).
    """
    ceps = np.atleast_2d(ceps)
    T, m1 = ceps.shape
    beta = 1.0 - alpha ** 2
    out = np.zeros((T, order + 1))
    d = np.zeros_like(out)
    for i in range(m1 - 1, -1, -1):
        d[:] = out
        out[:, 0] = ceps[:, i] + alpha * d[:, 0]
        if order >= 1:
            out[:, 1] = beta * d[:, 0] + alpha * d[:, 1]
        for m in range(2, order + 1):
            out[:, m] = d[:, m - 1] + alpha * (d[:, m] - out[:, m - 1])
    return out


def sp2mc(powerspec: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """Power spectrum (T, fftl/2+1) -> mel-cepstrum (T, order+1).

    pysptk-equivalent pipeline: log power -> real cepstrum (irfft) -> halve
    c0 -> freqt warping.
    """
    logsp = np.log(np.maximum(powerspec, 1e-30))
    c = np.fft.irfft(logsp, axis=-1)  # (T, fftl)
    half = c.shape[-1] // 2
    c = c[:, : half + 1].copy()
    c[:, 0] /= 2.0
    return freqt(c, order, alpha)


def cheaptrick(
    x: np.ndarray,
    f0: np.ndarray,
    fs: int,
    fft_size: int = MCEP_FFTL,
    shift_ms: float = MCEP_SHIFT,
    q1: float = -0.15,
) -> np.ndarray:
    """Native WORLD CheapTrick spectral envelope (Morise 2015).

    Faithful numpy port of the WORLD algorithm the reference reaches via
    ``pyworld.cheaptrick`` (the reference's ``utils/signal.py:119``):
    per frame, (1) pitch-adaptive Hanning windowing over 3 pitch periods with
    weighted-mean removal, (2) DC correction mirroring the spectrum below F0,
    (3) rectangular frequency smoothing of width 2/3 F0 on an interpolated
    power spectrum, (4) quefrency liftering with the sinc smoothing lifter
    and the (1-2q1)+2q1*cos compensation lifter.

    Args:
        x: float64 waveform (any scale), f0: (T,) Hz with 0 = unvoiced
        (analyzed at the WORLD default 500 Hz), frame shift ``shift_ms``.
    Returns:
        (T, fft_size//2+1) power spectral envelope.
    """
    x = np.asarray(x, np.float64)
    hop = fs * shift_ms / 1000.0
    n_bins = fft_size // 2 + 1
    freq_axis = np.arange(n_bins) * fs / fft_size
    default_f0 = 500.0
    f0_low_limit = fs * 3.0 / (fft_size - 3.0)
    out = np.zeros((len(f0), n_bins))

    quefrency = np.arange(1, n_bins) / fs
    for i in range(len(f0)):
        cf0 = float(f0[i]) if f0[i] > f0_low_limit else default_f0
        center = int(round(i * hop))
        # (1) pitch-adaptive windowed waveform, 1.5 periods each side
        half = int(round(1.5 * fs / cf0))
        base = np.arange(-half, half + 1)
        safe = np.clip(center + base, 0, len(x) - 1)
        win = 0.5 * np.cos(np.pi * (base / fs) * cf0 / 1.5) + 0.5
        wave = x[safe] * win
        wave = wave - win * (wave.sum() / win.sum())  # weighted mean removal
        ps = np.abs(np.fft.rfft(wave, n=fft_size)) ** 2 + 1e-30
        # (2) DC correction: mirror the spectrum around F0 for bins < F0
        low = freq_axis < cf0
        if low.any():
            ps[low] += np.interp(2.0 * cf0 - freq_axis[low], freq_axis, ps)
        # (3) rectangular smoothing, width 2/3 F0, on the interpolated
        # cumulative integral (matches WORLD's LinearSmoothing)
        width = 2.0 * cf0 / 3.0
        ext_freq = np.concatenate(([-freq_axis[1]], freq_axis, [freq_axis[-1] + freq_axis[1]]))
        ext_ps = np.concatenate(([ps[1]], ps, [ps[-2]]))  # mirror edges
        cum = np.concatenate(([0.0], np.cumsum(0.5 * (ext_ps[1:] + ext_ps[:-1]) * np.diff(ext_freq))))
        upper = np.interp(freq_axis + width / 2.0, ext_freq, np.concatenate(([0.0], cum[1:])))
        lower = np.interp(freq_axis - width / 2.0, ext_freq, np.concatenate(([0.0], cum[1:])))
        smoothed = np.maximum((upper - lower) / width, 1e-30)
        # (4) liftering in the quefrency domain
        log_ps = np.log(smoothed)
        # real cepstrum: log_ps is the (real, even) half spectrum
        cep = np.fft.irfft(log_ps, n=fft_size)[:n_bins]
        lifter = np.empty(n_bins)
        lifter[0] = 1.0
        arg = np.pi * cf0 * quefrency
        lifter[1:] = np.sin(arg) / arg  # sinc smoothing lifter
        comp = np.empty(n_bins)
        comp[0] = 1.0
        comp[1:] = (1.0 - 2.0 * q1) + 2.0 * q1 * np.cos(2.0 * np.pi * quefrency * cf0)
        cep = cep * lifter * comp
        full = np.concatenate([cep, cep[-2:0:-1]])
        out[i] = np.exp(np.fft.rfft(full).real)[:n_bins]
    return out


def spectral_envelope(x: np.ndarray, fs: int, fftl: int = MCEP_FFTL, shift_ms: float = MCEP_SHIFT):
    """Power spectrogram at a fixed frame shift (cheaptrick stand-in)."""
    hop = int(fs * shift_ms / 1000)
    win_len = fftl
    w = np.hanning(win_len + 1)[:-1]
    pad = fftl // 2
    xp = np.pad(x, pad, mode="reflect")
    n = 1 + (len(xp) - win_len) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(win_len)[None, :]
    frames = xp[idx] * w
    spec = np.abs(np.fft.rfft(frames, n=fftl, axis=-1)) ** 2
    return spec


def spc2npow(spectrogram: np.ndarray) -> np.ndarray:
    """Normalized power in dB per frame (reference ``signal.py:32-76``)."""
    fftl2 = spectrogram.shape[1] - 1
    fftl = fftl2 * 2
    power = (
        spectrogram[:, 0]
        + spectrogram[:, fftl2]
        + 2.0 * spectrogram[:, 1:fftl2].sum(axis=1)
    ) / fftl
    meanpow = np.mean(power)
    return 10.0 * np.log10(np.maximum(power / meanpow, 1e-30))


def extfrm(data: np.ndarray, npow: np.ndarray, power_threshold: float = -20):
    """Keep frames whose normalized power exceeds the threshold."""
    assert data.shape[0] == len(npow)
    return data[npow > power_threshold]


def acf_f0(
    x: np.ndarray,
    fs: int,
    f0min: float,
    f0max: float,
    shift_ms: float = MCEP_SHIFT,
    voicing_threshold: float = 0.45,
    n_candidates: int = 5,
    transition_cost: float = 0.35,
) -> np.ndarray:
    """RAPT-style autocorrelation pitch track (harvest stand-in).

    Per frame: the top-N normalized-ACF peaks (with parabolic sub-sample
    interpolation) are pitch candidates; a Viterbi pass over candidates with
    an octave-jump transition cost picks the contour, which removes the
    octave errors a greedy per-frame argmax makes. Returns (T,) Hz with
    0 = unvoiced (low ACF peak or power gate).
    """
    hop = int(fs * shift_ms / 1000)
    win = int(fs * 0.04)  # 40 ms analysis window
    lag_min = max(int(fs / f0max), 2)
    lag_max = min(int(np.ceil(fs / f0min)), win - 2)
    n = max(1 + (len(x) - win) // hop, 1)
    xpad = np.pad(x, (0, max(0, win + n * hop - len(x))))

    cand_f0 = np.zeros((n, n_candidates))
    cand_score = np.full((n, n_candidates), -1.0)
    frame_pow = np.zeros(n)
    for t in range(n):
        fr = xpad[t * hop : t * hop + win]
        fr = fr - fr.mean()
        frame_pow[t] = np.mean(fr ** 2)
        ac = np.correlate(fr, fr, mode="full")[win - 1 :]
        if ac[0] <= 0:
            continue
        ac = ac / ac[0]
        seg = ac[: lag_max + 2]
        # local maxima in the allowed lag range
        peaks = [
            k for k in range(lag_min, lag_max + 1)
            if seg[k] >= seg[k - 1] and seg[k] >= seg[k + 1]
        ]
        peaks.sort(key=lambda k: -seg[k])
        for j, k in enumerate(peaks[:n_candidates]):
            # parabolic interpolation around the peak for sub-sample lag
            denom = seg[k - 1] - 2 * seg[k] + seg[k + 1]
            delta = 0.5 * (seg[k - 1] - seg[k + 1]) / denom if denom != 0 else 0.0
            lag = k + np.clip(delta, -0.5, 0.5)
            cand_f0[t, j] = fs / lag
            cand_score[t, j] = seg[k]

    # Viterbi over candidates: emission = ACF peak height, transition
    # penalizes |log2(f0_a / f0_b)| (octave jumps cost ~transition_cost)
    best = np.zeros(n, dtype=np.int64)
    back = np.zeros((n, n_candidates), dtype=np.int64)
    score = np.where(cand_score[0] >= 0, cand_score[0], -1e9)
    for t in range(1, n):
        emit = np.where(cand_score[t] >= 0, cand_score[t], -1e9)
        fa = np.maximum(cand_f0[t - 1], 1e-6)[:, None]
        fb = np.maximum(cand_f0[t], 1e-6)[None, :]
        trans = transition_cost * np.abs(np.log2(fb / fa))
        total = score[:, None] - trans  # (prev, cur)
        back[t] = np.argmax(total, axis=0)
        score = total[back[t], np.arange(n_candidates)] + emit
    best_last = int(np.argmax(score))
    path = np.zeros(n, dtype=np.int64)
    path[-1] = best_last
    for t in range(n - 1, 0, -1):
        path[t - 1] = back[t, path[t]]
    f0 = cand_f0[np.arange(n), path]
    peak = cand_score[np.arange(n), path]

    f0[peak < voicing_threshold] = 0.0
    # power gate: silence is unvoiced
    pow_db = 10 * np.log10(np.maximum(frame_pow, 1e-12))
    f0[pow_db < pow_db.max() - 40] = 0.0
    return f0


def world_extract(x: np.ndarray, fs: int, f0min: float, f0max: float) -> Dict[str, np.ndarray]:
    """Feature extraction for MCD/F0 metrics. Uses pyworld+pysptk when
    importable (reference parity), else the native chain."""
    x = np.asarray(x, np.float64) * np.iinfo(np.int16).max
    x = low_cut_filter(x, fs)
    try:  # exact reference path if the packages exist
        import pyworld as pw
        import pysptk

        f0, time_axis = pw.harvest(
            x, fs, f0_floor=f0min, f0_ceil=f0max, frame_period=MCEP_SHIFT
        )
        sp = pw.cheaptrick(x, f0, time_axis, fs, fft_size=MCEP_FFTL)
        mcep = pysptk.sp2mc(sp, MCEP_DIM, MCEP_ALPHA)
    except ImportError:
        # native chain: Harvest port (evaluate/harvest.py) + faithful
        # CheapTrick port (same windowing/smoothing/liftering as
        # pyworld.cheaptrick)
        from .harvest import harvest_f0

        f0 = harvest_f0(
            x / np.iinfo(np.int16).max, fs, f0min, f0max, MCEP_SHIFT
        )
        sp = cheaptrick(x, f0, fs, MCEP_FFTL, MCEP_SHIFT)
        mcep = sp2mc(sp, MCEP_DIM, MCEP_ALPHA)
        L = min(len(f0), len(sp))
        sp, mcep, f0 = sp[:L], mcep[:L], f0[:L]
    npow = spc2npow(sp)
    return {"sp": sp, "mcep": mcep, "f0": f0, "npow": npow}
