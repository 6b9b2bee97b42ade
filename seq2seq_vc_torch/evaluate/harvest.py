"""Native Harvest F0 estimator (Morise 2017) for the evaluation chain.

A copy of seq2seq_vc_tpu/evaluate/harvest.py (host numpy there too), so
that the PyTorch port needs nothing of the JAX package.

Replaces the previous RAPT-style ACF stand-in when pyworld is absent,
mirroring the estimator the reference uses for its F0/DDUR metrics
(``utils/signal.py:108-130`` -> ``pyworld.harvest``). Implemented from the
paper's algorithm description, host-side numpy (evaluation is not a device
hot path):

1. The signal is decimated to ~8 kHz and band-pass filtered by a bank of
   Nuttall-windowed filters whose center frequencies are log-spaced at 24
   channels/octave over [f0_floor, f0_ceil]. When a channel's center is
   near the true F0, its output is near-sinusoidal at F0.
2. Per channel, four interval-based estimators (negative- and
   positive-going zero crossings, peaks, dips) yield instantaneous
   frequency tracks; a frame candidate is kept where the four agree
   (deviation-based reliability) and lies inside the channel's octave.
3. Candidates are refined against the ORIGINAL-rate signal by the
   instantaneous-frequency of the nearest STFT harmonics (amplitude- and
   harmonic-index-weighted), which also scores them.
4. The best-scored contour is cleaned like Harvest's FixF0Contour: voiced
   segments are broken at >18 % jumps, short segments dropped, segments
   extended by candidate re-selection near the extrapolated trajectory,
   and finally smoothed with a short zero-phase MA on voiced runs.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import fftconvolve, resample_poly

_CHANNELS_PER_OCTAVE = 24
_TARGET_FS = 8000.0
_MAX_CANDIDATES = 12
_ALLOWED_RANGE = 0.18  # max relative F0 jump between consecutive frames


def _nuttall(n: int) -> np.ndarray:
    t = np.linspace(0.0, 2.0 * np.pi, n, endpoint=True)
    return (0.355768 - 0.487396 * np.cos(t) + 0.144232 * np.cos(2 * t)
            - 0.012604 * np.cos(3 * t))


def _band_pass(x: np.ndarray, fs: float, center: float) -> np.ndarray:
    """Nuttall-windowed band-pass centered at ``center`` (bandwidth ~ one
    octave): the window envelope spans two periods of the center freq."""
    half = int(round(fs / center * 2.0))
    n = 2 * half + 1
    t = (np.arange(n) - half) / fs
    fir = _nuttall(n) * np.cos(2.0 * np.pi * center * t)
    fir = fir / np.sum(np.abs(fir))
    return fftconvolve(x, fir, mode="same")


def _crossing_times(y: np.ndarray, fs: float) -> np.ndarray:
    """Linearly-interpolated negative-going zero-crossing times of y."""
    s = np.signbit(y)
    idx = np.nonzero(~s[:-1] & s[1:])[0]
    if idx.size == 0:
        return np.empty(0)
    frac = y[idx] / (y[idx] - y[idx + 1])
    return (idx + frac) / fs


def _interval_track(times: np.ndarray):
    """(midpoint times, interval frequencies) from event times."""
    if times.size < 2:
        return np.empty(0), np.empty(0)
    iv = np.diff(times)
    good = iv > 1e-6
    return ((times[:-1] + times[1:]) / 2.0)[good], 1.0 / iv[good]


def _four_estimates(y: np.ndarray, fs: float):
    """Negative/positive zero-crossing, peak, and dip interval tracks."""
    dy = np.diff(y, prepend=y[:1])
    return [
        _interval_track(_crossing_times(y, fs)),
        _interval_track(_crossing_times(-y, fs)),
        _interval_track(_crossing_times(dy, fs)),
        _interval_track(_crossing_times(-dy, fs)),
    ]


def _channel_candidates(
    y: np.ndarray, fs: float, frame_times: np.ndarray, center: float,
    f0_floor: float, f0_ceil: float,
) -> np.ndarray:
    """Per-frame candidate F0 for one channel (0 where unreliable)."""
    tracks = _four_estimates(y, fs)
    interp = np.zeros((4, frame_times.size))
    for i, (tt, ff) in enumerate(tracks):
        if tt.size < 2:
            return np.zeros(frame_times.size)
        interp[i] = np.interp(frame_times, tt, ff, left=0.0, right=0.0)
    mean = interp.mean(axis=0)
    dev = np.sqrt(np.maximum(((interp - mean) ** 2).mean(axis=0), 0.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(mean > 0, dev / np.maximum(mean, 1e-9), 1.0)
    ok = (
        (rel < 0.2)
        & (mean >= np.maximum(f0_floor, center / np.sqrt(2.0)))
        & (mean <= np.minimum(f0_ceil, center * np.sqrt(2.0)))
    )
    return np.where(ok, mean, 0.0)


def _refine_batch(
    x: np.ndarray, fs: float, times: np.ndarray, f0s: np.ndarray,
    f0_floor: float, f0_ceil: float,
):
    """Instantaneous-frequency refinement + harmonicity scoring, batched.

    Per candidate, a Blackman-windowed snippet of ~3 periods around its
    frame time is analyzed; the refined F0 is the amplitude*harmonic-index
    weighted mean of IF/k over the first 6 harmonics (IF from the phase
    difference of two DFTs one sample apart) and the score is the mean
    normalized harmonic amplitude. Candidates are bucketed by a window half-length quantized up to
    multiples of 32 samples, so each bucket shares one Blackman window and
    one stacked batch rfft — a 10 s utterance refines ~20k candidates in a
    dozen vectorized FFT calls instead of 20k serial ones. (The quantized
    window covers >= 3 periods; refinement is insensitive to the extra
    samples.)
    """
    refined = f0s.astype(np.float64).copy()
    scores = np.zeros_like(refined)
    half = np.ceil(np.round(1.5 * fs / f0s) / 32).astype(np.int64) * 32
    centers = np.round(times * fs).astype(np.int64)

    for h in np.unique(half):
        sel = np.nonzero(half == h)[0]
        n = 2 * h + 1
        lo = centers[sel] - h
        ok = (lo >= 0) & (lo + n <= x.size) & (h >= 8)
        sel = sel[ok]
        if sel.size == 0:
            continue
        segs = x[(centers[sel] - h)[:, None] + np.arange(n)[None, :]]
        w = np.blackman(n)
        fft_size = int(2 ** np.ceil(np.log2(4 * n)))
        spec0 = np.fft.rfft(segs * w, fft_size, axis=1)
        # one-sample-delayed DFT for instantaneous frequency
        spec1 = np.fft.rfft(np.roll(segs, -1, axis=1) * w, fft_size, axis=1)
        df = fs / fft_size
        inst = np.angle(spec1 * np.conj(spec0)) * fs / (2.0 * np.pi)
        amp = np.abs(spec0)
        n_bins = amp.shape[1]
        total_amp = amp.max(axis=1) + 1e-12

        num = np.zeros(sel.size)
        den = np.zeros(sel.size)
        score_acc = np.zeros(sel.size)
        harmonics = np.zeros(sel.size)
        rows = np.arange(sel.size)
        for k in range(1, 7):
            target = k * f0s[sel]
            in_band = target <= fs / 2 - df
            bin_idx = np.clip(np.round(target / df).astype(np.int64), 0, n_bins - 1)
            # parabolic-free +-2-bin peak search via gathered columns
            offs = np.arange(-2, 3)
            cols = np.clip(bin_idx[:, None] + offs[None, :], 0, n_bins - 1)
            local = amp[rows[:, None], cols]
            j = cols[rows, np.argmax(local, axis=1)]
            a = amp[rows, j]
            f_inst = inst[rows, j]
            use = in_band & (f_inst > 0)
            num += np.where(use, a * k * (f_inst / k), 0.0)
            den += np.where(use, a * k, 0.0)
            score_acc += np.where(use, a / total_amp, 0.0)
            harmonics += use
        good = (den > 0) & (harmonics > 0)
        r = np.where(good, num / np.maximum(den, 1e-12), f0s[sel])
        in_range = (r >= f0_floor * 0.9) & (r <= f0_ceil * 1.1)
        good = good & in_range
        refined[sel] = np.where(good, r, f0s[sel])
        scores[sel] = np.where(
            good, score_acc / np.maximum(harmonics, 1), 0.0
        )
    return refined, scores


def _pick_contour(cands: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """Best-scored candidate per frame (0 where none)."""
    best = np.argmax(scores, axis=0)
    f0 = cands[best, np.arange(cands.shape[1])]
    sc = scores[best, np.arange(cands.shape[1])]
    return np.where(sc > 0.05, f0, 0.0)


def _voiced_runs(f0: np.ndarray):
    v = f0 > 0
    edges = np.diff(v.astype(np.int8), prepend=0, append=0)
    starts = np.nonzero(edges == 1)[0]
    ends = np.nonzero(edges == -1)[0]
    return list(zip(starts, ends))


def _fix_contour(
    f0: np.ndarray, cands: np.ndarray, min_frames: int
) -> np.ndarray:
    """Harvest-style contour fixing: split at >18 % jumps, drop short
    segments, then extend each segment over adjacent zeros by re-selecting
    the candidate nearest the extrapolated value."""
    out = f0.copy()
    # drop short voiced runs; the run scan below treats a >18 % jump as a
    # run boundary, so jump splitting falls out of the same pass
    runs = []
    cur = None
    for i in range(out.size):
        if out[i] > 0 and (
            cur is not None
            and out[i - 1] > 0
            and abs(out[i] - out[i - 1]) / out[i - 1] <= _ALLOWED_RANGE
        ):
            cur[1] = i + 1
        elif out[i] > 0:
            cur = [i, i + 1]
            runs.append(cur)
    for s, e in [tuple(r) for r in runs]:
        if e - s < min_frames:
            out[s:e] = 0.0
    # extend runs into neighboring unvoiced frames via candidate re-selection
    for s, e in _voiced_runs(out):
        # forward
        i = e
        while i < out.size and out[i] == 0:
            ref = out[i - 1]
            col = cands[:, i]
            good = col[(col > 0) & (np.abs(col - ref) / ref < _ALLOWED_RANGE)]
            if good.size == 0:
                break
            out[i] = good[np.argmin(np.abs(good - ref))]
            i += 1
        # backward
        i = s - 1
        while i >= 0 and out[i] == 0:
            ref = out[i + 1]
            col = cands[:, i]
            good = col[(col > 0) & (np.abs(col - ref) / ref < _ALLOWED_RANGE)]
            if good.size == 0:
                break
            out[i] = good[np.argmin(np.abs(good - ref))]
            i -= 1
    return out


def _smooth_contour(f0: np.ndarray) -> np.ndarray:
    """Zero-phase 3-point MA on each voiced run (edges kept)."""
    out = f0.copy()
    for s, e in _voiced_runs(f0):
        if e - s >= 3:
            seg = f0[s:e]
            sm = seg.copy()
            sm[1:-1] = (seg[:-2] + seg[1:-1] + seg[2:]) / 3.0
            out[s:e] = sm
    return out


def harvest_f0(
    x: np.ndarray,
    fs: int,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
    frame_period: float = 5.0,
) -> np.ndarray:
    """Harvest fundamental-frequency contour (0 = unvoiced).

    Args:
        x: waveform in [-1, 1] (any float scaling works; amplitude-invariant).
        fs: sampling rate.
        f0_floor, f0_ceil: search range in Hz.
        frame_period: hop in ms.
    Returns:
        (n_frames,) float64 F0 track at ``frame_period`` spacing.
    """
    x = np.asarray(x, np.float64)
    n_frames = int(len(x) / fs * 1000.0 / frame_period) + 1
    frame_times = np.arange(n_frames) * frame_period / 1000.0
    if x.size < int(fs * 0.05) or not np.any(x != 0):
        return np.zeros(n_frames)

    # decimate; keep enough band for f0_ceil's 2nd harmonic
    dec = max(1, int(fs // _TARGET_FS))
    fs_d = fs / dec
    while f0_ceil * 2.5 > fs_d / 2 and dec > 1:
        dec //= 2
        fs_d = fs / dec
    xd = resample_poly(x, 1, dec) if dec > 1 else x
    xd = xd - np.mean(xd)

    n_oct = np.log2(f0_ceil / f0_floor)
    n_ch = int(np.ceil(n_oct * _CHANNELS_PER_OCTAVE)) + 1
    centers = f0_floor * (2.0 ** (np.arange(n_ch) / _CHANNELS_PER_OCTAVE))

    raw = np.zeros((n_ch, n_frames))
    for ci, bf in enumerate(centers):
        y = _band_pass(xd, fs_d, bf)
        raw[ci] = _channel_candidates(
            y, fs_d, frame_times, bf, f0_floor, f0_ceil
        )

    # merge near-identical channel candidates per frame (keep strongest set)
    cands = np.zeros((_MAX_CANDIDATES, n_frames))
    counts = np.zeros(n_frames, np.int64)
    for ci in range(n_ch):
        col_ok = raw[ci] > 0
        for t in np.nonzero(col_ok)[0]:
            val = raw[ci, t]
            cur = cands[: counts[t], t]
            if cur.size and np.any(np.abs(cur - val) / val < 0.03):
                continue
            if counts[t] < _MAX_CANDIDATES:
                cands[counts[t], t] = val
                counts[t] += 1

    # IF refinement + scoring against the original-rate signal (batched)
    scores = np.zeros_like(cands)
    idx_c, idx_t = np.nonzero(cands > 0)
    if idx_t.size:
        refined, sc = _refine_batch(
            x, float(fs), frame_times[idx_t], cands[idx_c, idx_t],
            f0_floor, f0_ceil,
        )
        cands[idx_c, idx_t] = refined
        scores[idx_c, idx_t] = sc

    f0 = _pick_contour(cands, scores)
    min_frames = max(3, int(round(30.0 / frame_period)))  # >= 30 ms voiced
    f0 = _fix_contour(f0, cands, min_frames)
    return _smooth_contour(f0)
