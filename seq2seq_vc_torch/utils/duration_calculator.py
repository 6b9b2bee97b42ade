"""Durations from attention maps (a copy of
seq2seq_vc_tpu/utils/duration_calculator.py).

Teacher-forcing an AR model gives its cross-attention maps; the most
diagonal head (by focus rate) is hardened into per-input durations by an
argmax histogram. ``bin/vc_decode --use-teacher-forcing`` writes them as the
teacher durations of FastSpeech-VC training.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def calculate_focus_rate(att_ws: np.ndarray) -> float:
    """att_ws: (T_feats, T_text) or (#layers, #heads, T_feats, T_text)."""
    att_ws = np.asarray(att_ws)
    if att_ws.ndim == 2:
        return float(att_ws.max(axis=-1).mean())
    if att_ws.ndim == 4:
        return float(att_ws.max(axis=-1).mean(axis=-1).max())
    raise ValueError("att_ws should be 2 or 4 dimensional")


def calculate_durations(att_ws: np.ndarray) -> Tuple[np.ndarray, float]:
    """(durations (T_text,) int64, focus rate)."""
    att_ws = np.asarray(att_ws)
    focus = calculate_focus_rate(att_ws)
    if att_ws.ndim == 4:
        flat = att_ws.reshape(-1, att_ws.shape[-2], att_ws.shape[-1])
        diag_scores = flat.max(axis=-1).mean(axis=-1)
        att_ws = flat[int(np.argmax(diag_scores))]
    elif att_ws.ndim != 2:
        raise ValueError("att_ws should be 2 or 4 dimensional")
    arg = att_ws.argmax(axis=-1)
    durations = np.bincount(arg, minlength=att_ws.shape[1])
    return durations.astype(np.int64), focus
