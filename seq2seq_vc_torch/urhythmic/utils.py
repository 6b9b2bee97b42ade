"""Urhythmic shared types (a copy of seq2seq_vc_tpu/urhythmic/utils.py)."""

from __future__ import annotations

from enum import Flag, auto


class SoundType(Flag):
    VOWEL = auto()
    APPROXIMANT = auto()
    NASAL = auto()
    FRICATIVE = auto()
    STOP = auto()
    SILENCE = auto()


SONORANT = SoundType.VOWEL | SoundType.APPROXIMANT | SoundType.NASAL
OBSTRUENT = SoundType.FRICATIVE | SoundType.STOP
SILENCE = SoundType.SILENCE


class Metric:
    """Running mean."""

    def __init__(self):
        self.steps = 0
        self.value = 0.0

    def update(self, value: float) -> float:
        self.steps += 1
        self.value += (value - self.value) / self.steps
        return self.value

    def reset(self):
        self.steps = 0
        self.value = 0.0
