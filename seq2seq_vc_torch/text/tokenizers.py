"""Tokenizers (reference ``text/{abs,char,word,phoneme}_tokenizer.py``).

A copy of seq2seq_vc_tpu/text/tokenizers.py, so
that the PyTorch port needs nothing of the JAX package.

Char and word tokenizers are complete; the phoneme tokenizer resolves every
reference ``g2p_type`` (g2p_en, pyopenjtalk x5, pypinyin x2, espeak x12,
g2pk/jaso/ice-g2p — see ``g2p_backends.py``) by lazy try-import, erroring
only when the backing package is genuinely absent. English falls back to
the native rule-based G2P when g2p_en is missing. ``build_tokenizer``
mirrors the reference factory (``text/build_tokenizer.py:10``).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from pathlib import Path
from typing import Iterable, List, Optional, Union


class AbsTokenizer(ABC):
    @abstractmethod
    def text2tokens(self, line: str) -> List[str]:
        ...

    @abstractmethod
    def tokens2text(self, tokens: Iterable[str]) -> str:
        ...


class CharTokenizer(AbsTokenizer):
    def __init__(
        self,
        non_linguistic_symbols: Union[None, Path, str, Iterable[str]] = None,
        space_symbol: str = "<space>",
        remove_non_linguistic_symbols: bool = False,
    ):
        self.space_symbol = space_symbol
        if non_linguistic_symbols is None:
            self.non_linguistic_symbols = set()
        elif isinstance(non_linguistic_symbols, (Path, str)):
            with open(non_linguistic_symbols) as f:
                self.non_linguistic_symbols = {line.rstrip() for line in f}
        else:
            self.non_linguistic_symbols = set(non_linguistic_symbols)
        self.remove_non_linguistic_symbols = remove_non_linguistic_symbols

    def text2tokens(self, line: str) -> List[str]:
        tokens = []
        while line:
            for symbol in self.non_linguistic_symbols:
                if line.startswith(symbol):
                    if not self.remove_non_linguistic_symbols:
                        tokens.append(symbol)
                    line = line[len(symbol):]
                    break
            else:
                t = line[0]
                tokens.append(self.space_symbol if t == " " else t)
                line = line[1:]
        return tokens

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return "".join(" " if t == self.space_symbol else t for t in tokens)


class WordTokenizer(AbsTokenizer):
    def __init__(self, delimiter: Optional[str] = None):
        self.delimiter = delimiter

    def text2tokens(self, line: str) -> List[str]:
        return line.split(self.delimiter)

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return (self.delimiter or " ").join(tokens)


class PhonemeTokenizer(AbsTokenizer):
    """G2p-backed phoneme tokenizer. Supported backends are resolved at
    construction; missing packages raise with guidance."""

    def __init__(
        self,
        g2p_type: Optional[str],
        non_linguistic_symbols=None,
        space_symbol: str = "<space>",
        remove_non_linguistic_symbols: bool = False,
    ):
        self.g2p_type = g2p_type
        self.space_symbol = space_symbol
        if g2p_type is None:
            self.g2p = lambda text: text.split(" ")
        elif g2p_type in ("g2p_en", "g2p_en_no_space"):
            # reference keeps " " word separators for g2p_en and filters
            # them for g2p_en_no_space (ref phoneme_tokenizer.py:220-231)
            no_space = g2p_type.endswith("no_space")
            try:
                import g2p_en

                backend = g2p_en.G2p()
            except ImportError:
                import logging

                from .g2p_native import NativeEnglishG2p

                logging.warning(
                    "g2p_en is not installed; falling back to the native "
                    "rule-based English G2P (same ARPAbet token inventory, "
                    "lower accuracy on rare words)"
                )
                backend = NativeEnglishG2p()
            if no_space:
                self.g2p = lambda text: [p for p in backend(text) if p != " "]
            else:
                self.g2p = backend
        elif g2p_type in ("english_native", "english_native_no_space"):
            from .g2p_native import NativeEnglishG2p

            backend = NativeEnglishG2p()
            if g2p_type.endswith("no_space"):
                self.g2p = lambda text: [p for p in backend(text) if p != " "]
            else:
                self.g2p = backend
        else:
            # every other reference g2p_type (pyopenjtalk*, pypinyin*,
            # espeak_ng_*, g2pk*, korean_jaso*, g2p_is*) resolves by
            # try-import in g2p_backends — ImportError only when the
            # third-party package is genuinely absent (reference
            # phoneme_tokenizer.py:387-519 dispatch parity)
            from .g2p_backends import build_g2p_backend

            self.g2p = build_g2p_backend(g2p_type, space_symbol=space_symbol)

    def text2tokens(self, line: str) -> List[str]:
        return self.g2p(line)

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return "".join(tokens)


def build_tokenizer(
    token_type: str,
    non_linguistic_symbols=None,
    remove_non_linguistic_symbols: bool = False,
    space_symbol: str = "<space>",
    delimiter: Optional[str] = None,
    g2p_type: Optional[str] = None,
) -> AbsTokenizer:
    if token_type == "char":
        return CharTokenizer(
            non_linguistic_symbols=non_linguistic_symbols,
            space_symbol=space_symbol,
            remove_non_linguistic_symbols=remove_non_linguistic_symbols,
        )
    if token_type == "word":
        return WordTokenizer(delimiter=delimiter)
    if token_type == "phn":
        return PhonemeTokenizer(
            g2p_type=g2p_type,
            non_linguistic_symbols=non_linguistic_symbols,
            space_symbol=space_symbol,
            remove_non_linguistic_symbols=remove_non_linguistic_symbols,
        )
    raise ValueError(f"token_type must be char, word, or phn: {token_type}")
