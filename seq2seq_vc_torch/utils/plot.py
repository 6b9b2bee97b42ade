"""Decode-time diagnostic plots (mel / stop-prob / attention).

A copy of seq2seq_vc_tpu/utils/plot.py, so that the PyTorch port needs
nothing of the JAX package. The reference's plot helpers used by
``bin/vc_decode.py:315-340`` (plot_generated_and_ref_2d / plot_1d /
plot_attention). Plotting is best-effort: a failure (``matplotlib`` not
installed, a headless backend's error) is logged and never breaks
decoding.
"""

from __future__ import annotations

import logging
import os

import numpy as np


def _agg():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_2d(array: np.ndarray, path: str, origin: str = "lower") -> None:
    """Heat-map of a (T, D) feature array."""
    try:
        plt = _agg()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fig, ax = plt.subplots(figsize=(8, 4))
        im = ax.imshow(np.asarray(array).T, aspect="auto", origin=origin)
        fig.colorbar(im, ax=ax)
        fig.tight_layout()
        fig.savefig(path)
        plt.close(fig)
    except Exception as e:  # pragma: no cover - plotting is best-effort
        logging.warning("plot_2d failed for %s: %s", path, e)


def plot_1d(array: np.ndarray, path: str) -> None:
    """Line plot of a 1-D series (e.g. stop probabilities)."""
    try:
        plt = _agg()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fig, ax = plt.subplots(figsize=(8, 2.5))
        ax.plot(np.asarray(array))
        ax.set_ylim(0, 1)
        fig.tight_layout()
        fig.savefig(path)
        plt.close(fig)
    except Exception as e:  # pragma: no cover
        logging.warning("plot_1d failed for %s: %s", path, e)


def plot_attention(att_ws: np.ndarray, path: str) -> None:
    """Grid of attention maps.

    Accepts (T_out, T_in), (H, T_out, T_in) or (L, H, T_out, T_in); one
    subplot per head, rows = layers.
    """
    try:
        plt = _agg()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        a = np.asarray(att_ws)
        if a.ndim == 2:
            a = a[None, None]
        elif a.ndim == 3:
            a = a[None]
        L, H = a.shape[:2]
        fig, axes = plt.subplots(L, H, figsize=(2.5 * H, 2.5 * L), squeeze=False)
        for li in range(L):
            for hi in range(H):
                axes[li][hi].imshow(a[li, hi], aspect="auto", origin="lower")
                axes[li][hi].set_xticks([])
                axes[li][hi].set_yticks([])
        fig.tight_layout()
        fig.savefig(path)
        plt.close(fig)
    except Exception as e:  # pragma: no cover
        logging.warning("plot_attention failed for %s: %s", path, e)
