"""Non-English / third-party G2P backends with try-import dispatch.

A copy of seq2seq_vc_tpu/text/g2p_backends.py, so
that the PyTorch port needs nothing of the JAX package.

Capability match with reference ``text/phoneme_tokenizer.py:44-394``: every
``g2p_type`` value the reference resolves (pyopenjtalk x5, pypinyin x2,
phonemizer/espeak x12, g2pk x2, korean jaso x2, ice-g2p x2) is constructible
here, with the third-party package imported lazily at construction so an
ImportError is raised only when the package is GENUINELY absent — a user
with pyopenjtalk installed gets the working backend, everyone else gets a
clear error naming the missing dependency.

The extraction logic (full-context-label parsing, pinyin initial/final
splitting, prosody symbols) matches the reference semantics; tests inject
fake modules to exercise the dispatch without the real packages
(tests/test_jobs_and_text.py).
"""

from __future__ import annotations

import importlib
import logging
import re
from typing import Callable, Dict, List, Optional


def _require(package: str):
    try:
        return importlib.import_module(package)
    except ImportError as exc:  # genuine absence -> actionable error
        raise ImportError(
            f"this g2p backend requires the '{package}' package, which is "
            f"not installed ({exc}); install it to use this g2p_type"
        ) from exc


# --------------------------------------------------------------- pyopenjtalk
def _ojt_labels(ojt, text: str) -> List[str]:
    """Full-context labels for ``text``. Old pyopenjtalk returns
    ``(njd_features, labels)`` from run_frontend, new returns the features
    only (labels come from make_label) — support both."""
    out = ojt.run_frontend(text)
    if (
        isinstance(out, (tuple, list))
        and len(out) == 2
        and isinstance(out[1], list)
        and (not out[1] or isinstance(out[1][0], str))
    ):
        return out[1]
    return ojt.make_label(out)


def _label_field(label: str, pattern: str, default: int = -50) -> int:
    m = re.search(pattern, label)
    return default if m is None else int(m.group(1))


_ACCENT_RE = re.compile(r"\-(.*?)\+.*?\/A:([0-9\-]+).*?\/F:.*?_([0-9]+)")


class OpenJTalkG2p:
    """Japanese G2P via pyopenjtalk.

    Modes (= reference g2p_type values):
      ``phone``             -> pyopenjtalk (plain phoneme string)
      ``kana``              -> pyopenjtalk_kana
      ``accent``            -> pyopenjtalk_accent
      ``accent_with_pause`` -> pyopenjtalk_accent_with_pause
      ``prosody``           -> pyopenjtalk_prosody (Kurihara et al. 2021
                               prosody symbols, ref :101-172)
    """

    def __init__(self, mode: str = "phone"):
        self._ojt = _require("pyopenjtalk")
        self.mode = mode

    def __call__(self, text: str) -> List[str]:
        if self.mode == "phone":
            return self._ojt.g2p(text, kana=False).split(" ")
        if self.mode == "kana":
            return list(self._ojt.g2p(text, kana=True))
        if self.mode in ("accent", "accent_with_pause"):
            return self._accent(text, with_pause=self.mode.endswith("pause"))
        if self.mode == "prosody":
            return self._prosody(text)
        raise ValueError(f"unknown pyopenjtalk mode: {self.mode}")

    def _accent(self, text: str, with_pause: bool) -> List[str]:
        phones: List[str] = []
        for label in _ojt_labels(self._ojt, text):
            if with_pause and label.split("-")[1].split("+")[0] == "pau":
                phones.append("pau")
                continue
            hits = _ACCENT_RE.findall(label)
            if len(hits) == 1:
                ph, accent, mora = hits[0]
                phones += [ph, mora, accent]
        return phones

    def _prosody(self, text: str, drop_unvoiced_vowels: bool = True) -> List[str]:
        labels = _ojt_labels(self._ojt, text)
        n_labels = len(labels)
        symbols: List[str] = []
        for i, label in enumerate(labels):
            ph = re.search(r"\-(.*?)\+", label).group(1)
            if drop_unvoiced_vowels and ph in "AEIOU":
                ph = ph.lower()
            if ph == "sil":
                if i == 0:
                    symbols.append("^")
                elif i == n_labels - 1:
                    # sentence-final: question form closes with '?'
                    symbols.append(
                        "?" if _label_field(label, r"!(\d+)_") == 1 else "$"
                    )
                continue
            if ph == "pau":
                symbols.append("_")
                continue
            symbols.append(ph)
            a1 = _label_field(label, r"/A:([0-9\-]+)\+")
            a2 = _label_field(label, r"\+(\d+)\+")
            a3 = _label_field(label, r"\+(\d+)/")
            f1 = _label_field(label, r"/F:(\d+)_")
            a2_next = _label_field(labels[i + 1], r"\+(\d+)\+")
            if a3 == 1 and a2_next == 1 and ph in "aeiouAEIOUNcl":
                symbols.append("#")  # accent phrase border
            elif a1 == 0 and a2_next == a2 + 1 and a2 != f1:
                symbols.append("]")  # pitch fall
            elif a2 == 1 and a2_next == 2:
                symbols.append("[")  # pitch rise
        return symbols


# ------------------------------------------------------------------ pypinyin
class PinyinG2p:
    """Mandarin G2P via pypinyin. ``split_phone=True`` splits each syllable
    into initial / final(+tone digit) (= pypinyin_g2p_phone)."""

    def __init__(self, split_phone: bool = False):
        self._pypinyin = _require("pypinyin")
        self.split_phone = split_phone

    def __call__(self, text: str) -> List[str]:
        pinyin, style = self._pypinyin.pinyin, self._pypinyin.Style
        syllables = [s[0] for s in pinyin(text, style=style.TONE3)]
        if not self.split_phone:
            return syllables
        utils = importlib.import_module("pypinyin.style._utils")
        phones: List[str] = []
        for syl in syllables:
            if syl[-1].isdigit():
                final = utils.get_finals(syl[:-1], strict=True) + syl[-1]
            elif syl[-1].isalnum():
                final = utils.get_finals(syl, strict=True)
            else:
                final = syl
            for p in (utils.get_initials(syl, strict=True), final):
                if p and not p.isdigit():
                    phones.append(p)
        return phones


# ------------------------------------------------------- phonemizer / espeak
class PhonemizerG2p:
    """Wrapper over the phonemizer package (espeak etc.), matching the
    reference ``Phonemizer`` call contract (ref :306-352)."""

    def __init__(
        self,
        backend: str,
        word_separator: Optional[str] = None,
        syllable_separator: Optional[str] = None,
        phone_separator: Optional[str] = " ",
        strip: bool = False,
        split_by_single_token: bool = False,
        **backend_kwargs,
    ):
        phonemizer_backend = _require("phonemizer.backend")
        separator_mod = _require("phonemizer.separator")
        quiet = logging.getLogger("phonemizer")
        quiet.setLevel(logging.ERROR)
        self.separator = separator_mod.Separator(
            word=word_separator,
            syllable=syllable_separator,
            phone=phone_separator,
        )
        self.backend = phonemizer_backend.BACKENDS[backend](
            **backend_kwargs, logger=quiet
        )
        self.strip = strip
        self.split_by_single_token = split_by_single_token

    def __call__(self, text: str) -> List[str]:
        out = self.backend.phonemize(
            [text], separator=self.separator, strip=self.strip, njobs=1
        )[0]
        if not self.split_by_single_token:
            return out.split()
        return [c.replace(" ", "<space>") for c in out]


_ESPEAK_LANGS = {
    "espeak_ng_arabic": "ar",
    "espeak_ng_german": "de",
    "espeak_ng_french": "fr-fr",
    "espeak_ng_spanish": "es",
    "espeak_ng_russian": "ru",
    "espeak_ng_greek": "el",
    "espeak_ng_finnish": "fi",
    "espeak_ng_hungarian": "hu",
    "espeak_ng_dutch": "nl",
    "espeak_ng_hindi": "hi",
}


def _espeak(language: str, **kw) -> PhonemizerG2p:
    return PhonemizerG2p(
        backend="espeak",
        language=language,
        with_stress=True,
        preserve_punctuation=True,
        **kw,
    )


# ---------------------------------------------------------------- korean
class KoreanG2p:
    """Korean G2P via g2pk (ref ``G2pk``, :236-270)."""

    def __init__(self, no_space: bool = False):
        self._g2pk = _require("g2pk")
        self.no_space = no_space
        self._inst = None

    def __call__(self, text: str) -> List[str]:
        if self._inst is None:
            self._inst = self._g2pk.G2p()
        phones = list(
            self._inst(text, descriptive=False, group_vowels=False, to_syl=False)
        )
        if self.no_space:
            phones = [p for p in phones if p != " "]
        return phones


class JasoG2p:
    """Hangul -> jamo decomposition via the jamo package (ref ``Jaso``)."""

    _PUNC_AND_SPACE = set("!'(),-.:;? ")
    _VALID = (
        {chr(c) for c in range(0x1100, 0x1113)}  # leads
        | {chr(c) for c in range(0x1161, 0x1176)}  # vowels
        | {chr(c) for c in range(0x11A8, 0x11C3)}  # tails
        | _PUNC_AND_SPACE
    )

    def __init__(self, space_symbol: str = " ", no_space: bool = False):
        self._jamo = _require("jamo")
        self.space_symbol = space_symbol
        self.no_space = no_space

    def __call__(self, text: str) -> List[str]:
        jasos = [j for j in self._jamo.hangul_to_jamo(text) if j in self._VALID]
        if self.no_space:
            return [j for j in jasos if j != " "]
        return [self.space_symbol if j == " " else j for j in jasos]


# --------------------------------------------------------------- icelandic
class IcelandicG2p:
    """Icelandic G2P via ice-g2p (ref ``IsG2p``, :355-385)."""

    def __init__(self, dialect: str = "standard", word_sep: str = ","):
        transcriber_mod = _require("ice_g2p.transcriber")
        self.dialect = dialect
        self.transcriber = transcriber_mod.Transcriber(
            use_dict=True,
            syllab_symbol=".",
            stress_label=True,
            word_sep=word_sep,
            lang_detect=True,
        )

    def __call__(self, text: str) -> List[str]:
        return self.transcriber.transcribe(text).split()


# ---------------------------------------------------------------- registry
BACKEND_FACTORIES: Dict[str, Callable[[str], Callable[[str], List[str]]]] = {
    "pyopenjtalk": lambda space: OpenJTalkG2p("phone"),
    "pyopenjtalk_kana": lambda space: OpenJTalkG2p("kana"),
    "pyopenjtalk_accent": lambda space: OpenJTalkG2p("accent"),
    "pyopenjtalk_accent_with_pause": lambda space: OpenJTalkG2p(
        "accent_with_pause"
    ),
    "pyopenjtalk_prosody": lambda space: OpenJTalkG2p("prosody"),
    "pypinyin_g2p": lambda space: PinyinG2p(split_phone=False),
    "pypinyin_g2p_phone": lambda space: PinyinG2p(split_phone=True),
    **{
        name: (lambda space, _lang=lang: _espeak(_lang))
        for name, lang in _ESPEAK_LANGS.items()
    },
    # VITS-official-style English espeak tokenization (ref :499-510)
    "espeak_ng_english_us_vits": lambda space: _espeak(
        "en-us",
        strip=True,
        word_separator=" ",
        phone_separator="",
        split_by_single_token=True,
    ),
    "g2pk": lambda space: KoreanG2p(no_space=False),
    "g2pk_no_space": lambda space: KoreanG2p(no_space=True),
    "korean_jaso": lambda space: JasoG2p(space_symbol=space, no_space=False),
    "korean_jaso_no_space": lambda space: JasoG2p(no_space=True),
    "g2p_is": lambda space: IcelandicG2p(),
    "g2p_is_north": lambda space: IcelandicG2p(dialect="north"),
}


def build_g2p_backend(g2p_type: str, space_symbol: str = "<space>"):
    """Construct the named backend, importing its package lazily; raises
    ImportError only when the package is genuinely missing."""
    try:
        factory = BACKEND_FACTORIES[g2p_type]
    except KeyError:
        raise NotImplementedError(f"g2p_type={g2p_type}") from None
    return factory(space_symbol)
