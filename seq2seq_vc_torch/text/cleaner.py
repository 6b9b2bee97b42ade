"""Text cleaners (reference ``text/cleaner.py:16``).

A copy of seq2seq_vc_tpu/text/cleaner.py, so
that the PyTorch port needs nothing of the JAX package.

The 'tacotron' cleaner reimplements the espnet/tacotron custom English
cleaner chain natively (without the ``tacotron_cleaner``
package): uppercase, abbreviation + number expansion, punctuation and
whitespace normalization.
"""

from __future__ import annotations

import re
from typing import Collection, Optional

_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), expanded)
    for abbr, expanded in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
        ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
        ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
        ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
        ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]

_ONES = "zero one two three four five six seven eight nine ten eleven twelve thirteen fourteen fifteen sixteen seventeen eighteen nineteen".split()
_TENS = "zero ten twenty thirty forty fifty sixty seventy eighty ninety".split()


def _num_to_words(n: int) -> str:
    if n < 20:
        return _ONES[n]
    if n < 100:
        return _TENS[n // 10] + ("" if n % 10 == 0 else " " + _ONES[n % 10])
    if n < 1000:
        rest = n % 100
        return _ONES[n // 100] + " hundred" + ("" if rest == 0 else " " + _num_to_words(rest))
    for div, name in [(10 ** 9, "billion"), (10 ** 6, "million"), (10 ** 3, "thousand")]:
        if n >= div:
            rest = n % div
            return _num_to_words(n // div) + f" {name}" + (
                "" if rest == 0 else " " + _num_to_words(rest)
            )
    return str(n)


def _expand_numbers(text: str) -> str:
    def repl(m):
        try:
            return _num_to_words(int(m.group(0).replace(",", "")))
        except ValueError:
            return m.group(0)

    return re.sub(r"\d[\d,]*", repl, text)


def custom_english_cleaners(text: str) -> str:
    """Tacotron-style cleaner: expand + uppercase + normalize."""
    for pattern, expanded in _ABBREVIATIONS:
        text = pattern.sub(expanded, text)
    text = _expand_numbers(text)
    text = text.upper()
    text = re.sub(r"[\"\(\)\[\]]", "", text)
    text = re.sub(r"\s+", " ", text).strip()
    return text


class TextCleaner:
    """Apply a chain of named cleaners (reference semantics)."""

    def __init__(self, cleaner_types: Optional[Collection[str]] = None):
        if cleaner_types is None:
            cleaner_types = []
        elif isinstance(cleaner_types, str):
            cleaner_types = [cleaner_types]
        self.cleaner_types = list(cleaner_types)

    def __call__(self, text: str) -> str:
        for t in self.cleaner_types:
            if t == "tacotron":
                text = custom_english_cleaners(text)
            elif t in ("none", None):
                pass
            else:
                raise RuntimeError(f"Not supported: type={t}")
        return text
