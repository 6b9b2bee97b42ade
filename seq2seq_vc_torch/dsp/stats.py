"""Feature statistics and normalisation (a copy of
seq2seq_vc_tpu/dsp/stats.py:15-73).

``RunningStats`` gives sklearn ``StandardScaler.partial_fit``'s statistics
(population variance, a zero deviation mapped to 1) through a Chan/Welford
merge of per-chunk moments in float64 (``add_moments``: the JAX class's
``update`` step, its moments computed by the caller).
"""

from __future__ import annotations

import numpy as np


class RunningStats:
    """Per-dimension mean and scale over arrays of shape (T, D)."""

    def __init__(self):
        self.count = 0.0
        self.mean = None
        self.m2 = None

    def add_moments(self, n_b, mean_b: np.ndarray, m2_b: np.ndarray) -> "RunningStats":
        """Merge the moments of ``n_b`` rows: their mean and their sum of
        squared deviations from it (float64)."""
        if self.mean is None:
            self.mean = np.zeros(len(mean_b))
            self.m2 = np.zeros(len(mean_b))
        delta = mean_b - self.mean
        tot = self.count + n_b
        self.mean = self.mean + delta * (n_b / tot)
        self.m2 = self.m2 + m2_b + delta ** 2 * (self.count * n_b / tot)
        self.count = tot
        return self

    @property
    def scale(self) -> np.ndarray:
        """Population standard deviation (sklearn ``scale_``), 1 where it is 0."""
        std = np.sqrt(self.m2 / self.count)
        std[std == 0.0] = 1.0
        return std


def normalize(x, mean, scale):
    """z-normalise features."""
    return (np.asarray(x) - np.asarray(mean)) / np.asarray(scale)


def denormalize(x, mean, scale):
    """Invert z-normalisation (used before vocoding)."""
    return np.asarray(x) * np.asarray(scale) + np.asarray(mean)
