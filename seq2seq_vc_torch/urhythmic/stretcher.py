"""Urhythmic time stretchers (a copy of seq2seq_vc_tpu/urhythmic/stretcher.py,
on the host in numpy).

Per-segment (fine-grained) or whole-utterance (global) linear resampling of
soft speech units, matching torch ``F.interpolate(mode='linear',
align_corners=False)`` index arithmetic.
"""

from __future__ import annotations

import itertools
from typing import List

import numpy as np

from .utils import SILENCE, SoundType


def _interp_at(x: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Linearly sample (T, D) rows of ``x`` at fractional positions."""
    t_in = x.shape[0]
    pos = np.clip(pos, 0, t_in - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, t_in - 1)
    w = (pos - lo)[:, None]
    return (1 - w) * x[lo] + w * x[hi]


def linear_resize(x: np.ndarray, size: int) -> np.ndarray:
    """(T, D) -> (size, D) linear interpolation (torch align_corners=False)."""
    t_in = x.shape[0]
    if t_in == size:
        return x.copy()
    # sample positions: out center i maps to (i + 0.5) * T/size - 0.5
    return _interp_at(x, (np.arange(size) + 0.5) * (t_in / size) - 0.5)


class TimeStretcherFineGrained:
    def __call__(
        self,
        units: np.ndarray,
        clusters: List[SoundType],
        boundaries: List[int],
        tgt_durations: List[int],
    ) -> np.ndarray:
        """units: (T, D) soft units; returns stretched (T', D)."""
        segs = [
            units[t0:tn]
            for cluster, (t0, tn) in zip(clusters, itertools.pairwise(boundaries))
            if not cluster.value == SILENCE.value or tn - t0 > 3
        ]
        out = [
            linear_resize(seg, dur)
            for seg, dur in zip(segs, tgt_durations)
            if dur > 0
        ]
        return np.concatenate(out, axis=0)


class TimeStretcherGlobal:
    def __call__(self, units: np.ndarray, ratio: float) -> np.ndarray:
        # torch F.interpolate(scale_factor=ratio) semantics: the output size
        # floors, and the source positions come from the given ratio, not
        # t_in/size, through its float32 reciprocal
        # (src = (i + 0.5) * (1 / ratio) - 0.5 in float32)
        size = max(int(np.floor(units.shape[0] * ratio)), 1)
        pos = (
            (np.arange(size, dtype=np.float32) + np.float32(0.5))
            * np.float32(1.0 / ratio)
            - np.float32(0.5)
        )
        return _interp_at(units, pos)
