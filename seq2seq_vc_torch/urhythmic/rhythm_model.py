"""Urhythmic rhythm models (a copy of seq2seq_vc_tpu/urhythmic/rhythm_model.py,
on the host with ``scipy.stats``).

Fine-grained: fits per-sound-type gamma duration distributions for source
and target speakers; conversion maps each source segment duration through
source-CDF -> target-quantile. Global: matches overall speaking rates.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Mapping, Tuple

import numpy as np
import scipy.stats as stats

from .utils import SILENCE, SONORANT, SoundType


def transform(source, target, sample: float) -> float:
    """Quantile mapping: target.ppf(source.cdf(sample))."""
    return float(target.ppf(source.cdf(sample)))


def segment_rate(
    codes: List[SoundType],
    boundaries: List[int],
    sonorant: SoundType = SONORANT,
    silence: SoundType = SILENCE,
    unit_rate: float = 0.02,
) -> float:
    """Sonorant segments per non-silent second (for the global model)."""
    times = np.round(np.asarray(boundaries) * unit_rate, 2)
    segs = [
        (code, t0, tn)
        for code, (t0, tn) in zip(codes, itertools.pairwise(times))
        if code not in silence
    ]
    return len([c for c, _, _ in segs if c in sonorant]) / sum(
        tn - t0 for _, t0, tn in segs
    )


def _gamma_fit(d: np.ndarray) -> Tuple[float, float, float]:
    """gamma MLE with loc=0, robust to degenerate samples.

    ``scipy.stats.gamma.fit`` root-solves the MLE shape equation, which
    diverges when the sample has (near-)zero spread (all durations equal —
    happens on tiny corpora); fall back to a method-of-moments estimate
    with a spread floor in that case.
    """
    d = np.asarray(d, float)
    mean = float(np.mean(d))
    var = float(np.var(d))
    if d.size < 2 or var < 1e-12 * max(mean * mean, 1e-12):
        a = 1e4  # tightly concentrated around the (single) observed value
        return a, 0.0, mean / a
    try:
        return stats.gamma.fit(d, floc=0)
    except (ValueError, RuntimeError):
        a = mean * mean / var
        return a, 0.0, var / mean


class RhythmModelFineGrained:
    def __init__(self, hop_length: int = 320, sample_rate: int = 16000):
        self.hop_rate = hop_length / sample_rate
        self.source = None
        self.target = None

    def _tally_durations(
        self, utterances: List[Tuple[List[SoundType], List[int]]]
    ) -> Dict[SoundType, np.ndarray]:
        durations_dict: Dict[SoundType, list] = {}
        for clusters, boundaries in utterances:
            durations = np.diff(boundaries)
            for cluster, duration in zip(clusters, durations):
                if cluster.value == SILENCE.value and duration <= 3:
                    continue  # ignore silences that are too short
                durations_dict.setdefault(cluster, []).append(self.hop_rate * duration)
        return {c: np.asarray(d) for c, d in durations_dict.items()}

    def _fit(self, utterances) -> Mapping[SoundType, Tuple[float, ...]]:
        tally = self._tally_durations(utterances)
        return {c: _gamma_fit(d) for c, d in tally.items()}

    def fit_source(self, utterances):
        self.source = {
            c.value: stats.gamma(a, scale=scale)
            for c, (a, _, scale) in self._fit(utterances).items()
        }

    def fit_target(self, utterances):
        self.target = {
            c.value: stats.gamma(a, scale=scale)
            for c, (a, _, scale) in self._fit(utterances).items()
        }

    def state_dict(self):
        out = {}
        for name, dists in (("source", self.source), ("target", self.target)):
            if dists:
                out[name] = {
                    cluster: (dist.args[0], 0.0, dist.kwds["scale"])
                    for cluster, dist in dists.items()
                }
        return out

    def load_state_dict(self, state_dict):
        for name in ("source", "target"):
            if name in state_dict:
                dists = {
                    int(cluster): stats.gamma(a, scale=scale)
                    for cluster, (a, _, scale) in state_dict[name].items()
                }
                setattr(self, name, dists)

    def __call__(self, clusters: List[SoundType], boundaries: List[int]) -> List[int]:
        """Transform source segment durations to the target rhythm (frames).

        Sound types never observed while fitting either speaker (possible
        on tiny corpora) keep their source duration (identity stretch).
        """
        durations = self.hop_rate * np.diff(boundaries)
        out = [
            transform(self.source[c.value], self.target[c.value], d)
            if c.value in self.source and c.value in self.target
            else d
            for c, d in zip(clusters, durations)
            if not c.value == SILENCE.value or d > 3 * self.hop_rate
        ]
        return [round(d / self.hop_rate) for d in out]


class RhythmModelGlobal:
    """Global speaking-rate model (rate ratio between speakers)."""

    def __init__(self, hop_length: int = 320, sample_rate: int = 16000):
        self.unit_rate = hop_length / sample_rate
        self.source_rate = None
        self.target_rate = None

    def _rate(self, utterances) -> float:
        rates = [
            segment_rate(codes, bounds, unit_rate=self.unit_rate)
            for codes, bounds in utterances
        ]
        return float(np.mean(rates))

    def fit_source(self, utterances):
        self.source_rate = self._rate(utterances)

    def fit_target(self, utterances):
        self.target_rate = self._rate(utterances)

    def state_dict(self):
        return {"source_rate": self.source_rate, "target_rate": self.target_rate}

    def load_state_dict(self, sd):
        self.source_rate = sd.get("source_rate")
        self.target_rate = sd.get("target_rate")

    def __call__(self) -> float:
        """Interpolation ratio source/target for the global stretcher."""
        return self.source_rate / self.target_rate
