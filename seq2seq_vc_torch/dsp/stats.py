"""Feature normalisation (a copy of seq2seq_vc_tpu/dsp/stats.py:66-73)."""

from __future__ import annotations

import numpy as np


def normalize(x, mean, scale):
    """z-normalise features."""
    return (np.asarray(x) - np.asarray(mean)) / np.asarray(scale)


def denormalize(x, mean, scale):
    """Invert z-normalisation (used before vocoding)."""
    return np.asarray(x) * np.asarray(scale) + np.asarray(mean)
