"""Urhythmic segmentation block (mirrors seq2seq_vc_tpu/urhythmic/segmenter.py,
on the host in numpy; the clustering is ``cluster.AgglomerativeClustering``).

Groups similar speech units into short segments via a DP over discrete-unit
log-probabilities (with a gamma reward for longer segments), merges the
segments into three agglomerative clusters, and identifies which cluster is
sonorant / obstruent / silence from overlap statistics.

The segment score is a prefix-sum difference, so the DP is vectorized per
frame over (candidate starts x units) with O(TK) memory. ``state_dict`` is
the JAX package's pickle format (numpy arrays and ints): a file written by
either package loads in the other, with no sklearn.
"""

from __future__ import annotations

import itertools
from collections import Counter
from typing import Any, List, Mapping, Tuple

import numpy as np

from .cluster import AgglomerativeClustering
from .utils import OBSTRUENT, SILENCE, SONORANT, SoundType


def segment(log_probs: np.ndarray, gamma: float) -> Tuple[np.ndarray, np.ndarray]:
    """DP segmentation of (T, K) unit log-probs.

    Returns (codes (T,), boundaries (N+1,)): per-frame best unit and the
    optimal segment boundaries maximizing
    sum over segments of (max_k sum_t log_probs[t, k]) + gamma * (len - 1).
    """
    log_probs = np.asarray(log_probs, np.float32)
    T, K = log_probs.shape
    csum = np.concatenate([np.zeros((1, K), np.float32), np.cumsum(log_probs, 0)])

    alpha = np.zeros(T + 1, np.float32)
    prev = np.zeros(T + 1, np.int32)
    best_code = np.zeros(T + 1, np.int32)
    for t in range(T):
        # candidate segment starts a = 0..t covering frames a..t
        seg_scores = csum[t + 1][None, :] - csum[: t + 1]  # (t+1, K)
        k_best = np.argmax(seg_scores, axis=1)
        scores = (
            alpha[: t + 1]
            + seg_scores[np.arange(t + 1), k_best]
            + gamma * (t - np.arange(t + 1))
        )
        a = int(np.argmax(scores))
        alpha[t + 1] = scores[a]
        prev[t + 1] = a
        best_code[t + 1] = k_best[a]

    # backtrack
    codes = np.zeros(T, np.int32)
    boundaries = [T]
    rhs = T
    while rhs != 0:
        lhs = int(prev[rhs])
        codes[lhs:rhs] = best_code[rhs]
        boundaries.append(lhs)
        rhs = lhs
    boundaries.reverse()
    return codes, np.asarray(boundaries)


def cluster_merge(
    labels: np.ndarray, segments: np.ndarray, boundaries: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge adjacent segments that fall into the same cluster."""
    clusters = labels[segments]
    switches = np.diff(clusters, prepend=-1, append=-1)
    (cluster_boundaries,) = np.nonzero(switches)
    clusters = clusters[cluster_boundaries[:-1]]
    cluster_boundaries = boundaries[cluster_boundaries]
    return clusters, cluster_boundaries


class Segmenter:
    def __init__(self, num_clusters: int = 3, gamma: float = 2):
        self.gamma = gamma
        self.clustering = AgglomerativeClustering(n_clusters=num_clusters)
        self.sound_types: Mapping[int, SoundType] = {}

    # -- persistence -------------------------------------------------------
    def state_dict(self) -> Mapping[str, Any]:
        return {
            "n_clusters_": self.clustering.n_clusters_,
            "labels_": np.asarray(self.clustering.labels_),
            "n_leaves_": self.clustering.n_leaves_,
            "n_features_in_": self.clustering.n_features_in_,
            "children_": np.asarray(self.clustering.children_),
            "sound_types": {k: v.value for k, v in self.sound_types.items()},
        }

    def load_state_dict(self, state_dict: Mapping[str, Any]):
        if self.clustering.n_clusters != state_dict["n_clusters_"]:
            raise RuntimeError("n_clusters mismatch in Segmenter state")
        self.clustering.labels_ = np.asarray(state_dict["labels_"])
        self.clustering.n_leaves_ = state_dict["n_leaves_"]
        self.clustering.n_features_in_ = state_dict["n_features_in_"]
        self.clustering.children_ = np.asarray(state_dict["children_"])
        self.sound_types = {
            int(k): SoundType(v) for k, v in state_dict["sound_types"].items()
        }

    # -- fitting -----------------------------------------------------------
    def cluster(self, codebook: np.ndarray):
        """Fit agglomerative clustering on the (K, D) unit codebook."""
        self.clustering.fit(codebook)

    def identify(self, utterances: List[Tuple[np.ndarray, ...]]) -> Mapping[int, SoundType]:
        """Map cluster ids to {sonorant, obstruent, silence} using silence /
        voicing overlap statistics (num_clusters == 3 only)."""
        if self.clustering.n_clusters_ != 3:
            raise ValueError("cluster identification requires num_clusters == 3")
        silence_overlap: Counter = Counter()
        voiced_overlap: Counter = Counter()
        total: Counter = Counter()
        for segments, boundaries, silences, voiced_flags in utterances:
            for code, (a, b) in zip(segments, itertools.pairwise(boundaries)):
                silence_overlap[code] += int(np.count_nonzero(silences[a : b + 1]))
                voiced_overlap[code] += int(np.count_nonzero(voiced_flags[a : b + 1]))
                total[code] += b - a + 1

        clusters = {0, 1, 2}
        silence, _ = max(
            ((k, v / total[k]) for k, v in silence_overlap.items()), key=lambda x: x[1]
        )
        clusters.remove(silence)
        sonorant, _ = max(
            ((k, v / total[k]) for k, v in voiced_overlap.items() if k in clusters),
            key=lambda x: x[1],
        )
        clusters.remove(sonorant)
        obstruent = clusters.pop()
        self.sound_types = {silence: SILENCE, sonorant: SONORANT, obstruent: OBSTRUENT}
        return self.sound_types

    # -- inference ---------------------------------------------------------
    def _segment(self, log_probs: np.ndarray) -> Tuple[List[int], List[int]]:
        codes, boundaries = segment(log_probs, self.gamma)
        segments = codes[boundaries[:-1]]
        segments, boundaries = cluster_merge(
            self.clustering.labels_, segments, boundaries
        )
        return list(segments), list(boundaries)

    def __call__(self, log_probs: np.ndarray) -> Tuple[List[SoundType], List[int]]:
        segments, boundaries = self._segment(log_probs)
        return [self.sound_types[c] for c in segments], boundaries
