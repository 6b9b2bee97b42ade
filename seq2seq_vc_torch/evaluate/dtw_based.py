"""Objective evaluation metrics: MCD, F0RMSE, F0CORR, DDUR, GV.

A copy of seq2seq_vc_tpu/evaluate/dtw_based.py (host numpy there too), so
that the PyTorch port needs nothing of the JAX package.

Mirrors reference ``evaluate/dtw_based.py:11-72`` exactly in metric
definitions: power-VAD'ed mel-cepstra aligned by DTW for MCD
(10/ln10 * sqrt(2*sum d^2)), voiced-frame DTW for F0 metrics, energy-trim
duration difference for DDUR. The analysis chain is exact-reference when
pyworld/pysptk exist, else the native chain in ``evaluate/signal.py``.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import scipy.stats

from .dtw import dtw_path
from .signal import extfrm, world_extract


def _trim_silence_len(x: np.ndarray, fs: int, top_db: float = 60.0) -> int:
    """Length after librosa-style energy trim (for DDUR)."""
    frame, hop = 2048, 512
    if len(x) < frame:
        return len(x)
    n = 1 + (len(x) - frame) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    rms = np.sqrt(np.mean(x[idx] ** 2, axis=1))
    db = 20 * np.log10(np.maximum(rms, 1e-10))
    keep = db > db.max() - top_db
    if not keep.any():
        return len(x)
    first, last = np.argmax(keep), len(keep) - 1 - np.argmax(keep[::-1])
    return min(len(x), last * hop + frame) - first * hop


def calculate_mcd_f0(
    x: np.ndarray, y: np.ndarray, fs: int, f0min: float, f0max: float,
    calculate_gv: bool = False,
) -> Dict[str, float]:
    """x = ground truth waveform, y = converted waveform, both in [-1, 1]."""
    gt_feats = world_extract(x, fs, f0min, f0max)
    cvt_feats = world_extract(y, fs, f0min, f0max)

    # MCD over power-VAD'ed frames, DTW aligned
    gt_mcep_nonsil = extfrm(gt_feats["mcep"], gt_feats["npow"])
    cvt_mcep_nonsil = extfrm(cvt_feats["mcep"], cvt_feats["npow"])
    _, path = dtw_path(cvt_mcep_nonsil, gt_mcep_nonsil)
    twf = np.array(path).T
    cvt_dtw = cvt_mcep_nonsil[twf[0]]
    gt_dtw = gt_mcep_nonsil[twf[1]]
    diff2sum = np.sum((cvt_dtw - gt_dtw) ** 2, axis=1)
    mcd = float(np.mean(10.0 / np.log(10.0) * np.sqrt(2 * diff2sum)))

    # F0 metrics over voiced frames, DTW aligned on mceps of voiced frames
    gt_vuv = np.where(gt_feats["f0"] > 0)[0]
    cvt_vuv = np.where(cvt_feats["f0"] > 0)[0]
    try:
        if len(gt_vuv) == 0 or len(cvt_vuv) == 0:
            raise ValueError("no voiced frames")
        _, path = dtw_path(cvt_feats["mcep"][cvt_vuv], gt_feats["mcep"][gt_vuv])
        twf_f0 = np.array(path).T
        cvt_f0_dtw = cvt_feats["f0"][cvt_vuv][twf_f0[0]]
        gt_f0_dtw = gt_feats["f0"][gt_vuv][twf_f0[1]]
        f0rmse = float(np.sqrt(np.mean((cvt_f0_dtw - gt_f0_dtw) ** 2)))
        f0corr = float(scipy.stats.pearsonr(cvt_f0_dtw, gt_f0_dtw)[0])
    except ValueError:
        logging.warning("No nonzero f0 found; setting F0RMSE/F0CORR to NaN.")
        f0rmse, f0corr = float("nan"), float("nan")

    ddur = abs(_trim_silence_len(x, fs) - _trim_silence_len(y, fs)) / fs

    ret = {"MCD": mcd, "F0RMSE": f0rmse, "F0CORR": f0corr, "DDUR": float(ddur)}
    if calculate_gv:
        ret["GV"] = float(
            np.mean(np.abs(np.log(np.var(cvt_mcep_nonsil, axis=0))))
        )
    return ret
