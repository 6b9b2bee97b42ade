"""Dependency-free rule-based English G2P producing ARPAbet phonemes.

A copy of seq2seq_vc_tpu/text/g2p_native.py, so
that the PyTorch port needs nothing of the JAX package.

The reference's phoneme path (``seq2seq_vc/text/phoneme_tokenizer.py:210-231``)
wraps ``g2p_en.G2p``, which needs CMUdict plus trained-model data that the
package does not ship. This module is a self-contained
replacement so ``token_type: phn`` recipes (LJSpeech TTS, ref
``egs/ljspeech/tts1/conf``) run natively:

- text normalization with built-in number expansion (no ``inflect``),
- an exceptions lexicon of common/irregular English words with CMUdict-style
  stress digits,
- NRL-style context-sensitive letter-to-sound rules (after Elovitz et al.
  1976, "Automatic translation of English text to phonetics", re-derived
  here to emit ARPAbet directly) for out-of-lexicon words,
- a first-vowel primary-stress heuristic for rule-derived pronunciations.

Output token inventory matches g2p_en: ARPAbet with stress digits on vowels
(e.g. ``HH AH0 L OW1``) and ``" "`` tokens separating words, so downstream
token-list handling (``text/tokenizers.py``) is unchanged. Accuracy on rare
words is below a dictionary+neural G2P — this is a documented behavioral
deviation, preferred over failing the phn path entirely.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, List, Sequence, Tuple

_VOWELS = "aeiouy"
_VOICED = "bdvgjlmnrwz"  # NRL "." class
_FRONT = "eiy"  # NRL "+" class
_SIBILANT_1 = "scgzxj"  # NRL "&" single letters (plus digraphs ch, sh)
_T_CLASS_1 = "tsrdlznj"  # NRL "@" single letters (plus digraphs th, ch, sh)
_SUFFIXES = ("er", "e", "es", "ed", "ing", "ely")  # NRL "%" class

ARPABET_VOWELS = frozenset(
    "AA AE AH AO AW AY EH ER EY IH IY OW OY UH UW".split()
)

# ---------------------------------------------------------------------------
# exceptions lexicon: common words, function words, and irregulars whose
# spellings defeat letter-to-sound rules. Stress digits included (CMUdict
# conventions). Kept deliberately to high-frequency items.
# ---------------------------------------------------------------------------
_LEXICON: Dict[str, str] = {
    # high-frequency irregulars the letter-to-sound rules get wrong
    "honest": "AA1 N AH0 S T",
    "half": "HH AE1 F",
    "none": "N AH1 N",
    "lose": "L UW1 Z",
    "money": "M AH1 N IY0",
    "touch": "T AH1 CH",
    "country": "K AH1 N T R IY0",
    "blood": "B L AH1 D",
    "flood": "F L AH1 D",
    "shoe": "SH UW1",
    "shoes": "SH UW1 Z",
    "shown": "SH OW1 N",
    "grown": "G R OW1 N",
    "thrown": "TH R OW1 N",
    "blown": "B L OW1 N",
    "a": "AH0",
    "an": "AH0 N",
    "the": "DH AH0",
    "of": "AH1 V",
    "to": "T UW1",
    "and": "AH0 N D",
    "in": "IH0 N",
    "is": "IH1 Z",
    "it": "IH1 T",
    "you": "Y UW1",
    "that": "DH AE1 T",
    "he": "HH IY1",
    "she": "SH IY1",
    "was": "W AA1 Z",
    "for": "F AO1 R",
    "on": "AA1 N",
    "are": "AA1 R",
    "as": "AE1 Z",
    "with": "W IH1 DH",
    "his": "HH IH1 Z",
    "hers": "HH ER1 Z",
    "they": "DH EY1",
    "i": "AY1",
    "at": "AE1 T",
    "be": "B IY1",
    "this": "DH IH1 S",
    "have": "HH AE1 V",
    "has": "HH AE1 Z",
    "had": "HH AE1 D",
    "from": "F R AH1 M",
    "or": "AO1 R",
    "one": "W AH1 N",
    "once": "W AH1 N S",
    "by": "B AY1",
    "but": "B AH1 T",
    "not": "N AA1 T",
    "what": "W AH1 T",
    "all": "AO1 L",
    "were": "W ER1",
    "we": "W IY1",
    "when": "W EH1 N",
    "where": "W EH1 R",
    "there": "DH EH1 R",
    "their": "DH EH1 R",
    "your": "Y AO1 R",
    "can": "K AE1 N",
    "said": "S EH1 D",
    "says": "S EH1 Z",
    "use": "Y UW1 S",
    "used": "Y UW1 Z D",
    "each": "IY1 CH",
    "which": "W IH1 CH",
    "do": "D UW1",
    "does": "D AH1 Z",
    "done": "D AH1 N",
    "how": "HH AW1",
    "if": "IH1 F",
    "will": "W IH1 L",
    "would": "W UH1 D",
    "could": "K UH1 D",
    "should": "SH UH1 D",
    "up": "AH1 P",
    "other": "AH1 DH ER0",
    "about": "AH0 B AW1 T",
    "out": "AW1 T",
    "many": "M EH1 N IY0",
    "any": "EH1 N IY0",
    "then": "DH EH1 N",
    "them": "DH EH1 M",
    "these": "DH IY1 Z",
    "those": "DH OW1 Z",
    "so": "S OW1",
    "some": "S AH1 M",
    "her": "HH ER1",
    "him": "HH IH1 M",
    "me": "M IY1",
    "my": "M AY1",
    "no": "N OW1",
    "yes": "Y EH1 S",
    "make": "M EY1 K",
    "like": "L AY1 K",
    "into": "IH1 N T UW0",
    "time": "T AY1 M",
    "look": "L UH1 K",
    "two": "T UW1",
    "more": "M AO1 R",
    "go": "G OW1",
    "goes": "G OW1 Z",
    "gone": "G AO1 N",
    "see": "S IY1",
    "way": "W EY1",
    "who": "HH UW1",
    "whom": "HH UW1 M",
    "whose": "HH UW1 Z",
    "its": "IH1 T S",
    "now": "N AW1",
    "find": "F AY1 N D",
    "long": "L AO1 NG",
    "down": "D AW1 N",
    "day": "D EY1",
    "did": "D IH1 D",
    "get": "G EH1 T",
    "come": "K AH1 M",
    "comes": "K AH1 M Z",
    "made": "M EY1 D",
    "may": "M EY1",
    "people": "P IY1 P AH0 L",
    "water": "W AO1 T ER0",
    "been": "B IH1 N",
    "being": "B IY1 IH0 NG",
    "than": "DH AE1 N",
    "first": "F ER1 S T",
    "very": "V EH1 R IY0",
    "after": "AE1 F T ER0",
    "our": "AW1 ER0",
    "us": "AH1 S",
    "good": "G UH1 D",
    "give": "G IH1 V",
    "given": "G IH1 V AH0 N",
    "only": "OW1 N L IY0",
    "little": "L IH1 T AH0 L",
    "know": "N OW1",
    "knew": "N UW1",
    "known": "N OW1 N",
    "place": "P L EY1 S",
    "year": "Y IH1 R",
    "years": "Y IH1 R Z",
    "live": "L IH1 V",
    "lives": "L IH1 V Z",
    "back": "B AE1 K",
    "most": "M OW1 S T",
    "over": "OW1 V ER0",
    "think": "TH IH1 NG K",
    "thought": "TH AO1 T",
    "through": "TH R UW1",
    "though": "DH OW1",
    "tough": "T AH1 F",
    "enough": "IH0 N AH1 F",
    "rough": "R AH1 F",
    "cough": "K AO1 F",
    "laugh": "L AE1 F",
    "also": "AO1 L S OW0",
    "around": "ER0 AW1 N D",
    "another": "AH0 N AH1 DH ER0",
    "came": "K EY1 M",
    "work": "W ER1 K",
    "three": "TH R IY1",
    "word": "W ER1 D",
    "words": "W ER1 D Z",
    "world": "W ER1 L D",
    "because": "B IH0 K AO1 Z",
    "here": "HH IY1 R",
    "why": "W AY1",
    "again": "AH0 G EH1 N",
    "against": "AH0 G EH1 N S T",
    "off": "AO1 F",
    "away": "AH0 W EY1",
    "always": "AO1 L W EY0 Z",
    "often": "AO1 F AH0 N",
    "something": "S AH1 M TH IH0 NG",
    "nothing": "N AH1 TH IH0 NG",
    "anything": "EH1 N IY0 TH IH0 NG",
    "everything": "EH1 V R IY0 TH IH0 NG",
    "every": "EH1 V ER0 IY0",
    "never": "N EH1 V ER0",
    "even": "IY1 V AH0 N",
    "own": "OW1 N",
    "eye": "AY1",
    "eyes": "AY1 Z",
    "heart": "HH AA1 R T",
    "head": "HH EH1 D",
    "hear": "HH IY1 R",
    "heard": "HH ER1 D",
    "earth": "ER1 TH",
    "early": "ER1 L IY0",
    "learn": "L ER1 N",
    "great": "G R EY1 T",
    "break": "B R EY1 K",
    "mr": "M IH1 S T ER0",
    "mrs": "M IH1 S IH0 Z",
    "dr": "D AA1 K T ER0",
    "st": "S T R IY1 T",
    "etc": "EH0 T S EH1 T ER0 AH0",
    "house": "HH AW1 S",
    "move": "M UW1 V",
    "love": "L AH1 V",
    "above": "AH0 B AH1 V",
    "prove": "P R UW1 V",
    "before": "B IH0 F AO1 R",
    "between": "B IH0 T W IY1 N",
    "both": "B OW1 TH",
    "during": "D UH1 R IH0 NG",
    "under": "AH1 N D ER0",
    "until": "AH0 N T IH1 L",
    "while": "W AY1 L",
    "without": "W IH0 TH AW1 T",
    "within": "W IH0 TH IH1 N",
    "toward": "T AH0 W AO1 R D",
    "towards": "T AH0 W AO1 R D Z",
    "really": "R IH1 L IY0",
    "business": "B IH1 Z N AH0 S",
    "busy": "B IH1 Z IY0",
    "woman": "W UH1 M AH0 N",
    "women": "W IH1 M AH0 N",
    "island": "AY1 L AH0 N D",
    "iron": "AY1 ER0 N",
    "answer": "AE1 N S ER0",
    "listen": "L IH1 S AH0 N",
    "beautiful": "B Y UW1 T AH0 F AH0 L",
    "friend": "F R EH1 N D",
    "friends": "F R EH1 N D Z",
    "minute": "M IH1 N AH0 T",
    "colonel": "K ER1 N AH0 L",
    "choir": "K W AY1 ER0",
    "height": "HH AY1 T",
    "weight": "W EY1 T",
    "eight": "EY1 T",
    "eighty": "EY1 T IY0",
    "eighteen": "EY0 T IY1 N",
    "heavy": "HH EH1 V IY0",
    "ocean": "OW1 SH AH0 N",
    "sugar": "SH UH1 G ER0",
    "sure": "SH UH1 R",
    "machine": "M AH0 SH IY1 N",
    "stomach": "S T AH1 M AH0 K",
    "recipe": "R EH1 S AH0 P IY0",
    "voice": "V OY1 S",
    "nature": "N EY1 CH ER0",
    "natural": "N AE1 CH ER0 AH0 L",
    "character": "K EH1 R AH0 K T ER0",
    "characters": "K EH1 R AH0 K T ER0 Z",
    "wave": "W EY1 V",
    "waves": "W EY1 V Z",
    "language": "L AE1 NG G W AH0 JH",
    "speech": "S P IY1 CH",
    "oh": "OW1",
    "okay": "OW2 K EY1",
    # number words the expander emits
    "zero": "Z IY1 R OW0",
    "four": "F AO1 R",
    "five": "F AY1 V",
    "six": "S IH1 K S",
    "seven": "S EH1 V AH0 N",
    "nine": "N AY1 N",
    "ten": "T EH1 N",
    "eleven": "IH0 L EH1 V AH0 N",
    "twelve": "T W EH1 L V",
    "thirteen": "TH ER1 T IY1 N",
    "fourteen": "F AO1 R T IY1 N",
    "fifteen": "F IH1 F T IY1 N",
    "sixteen": "S IH1 K S T IY1 N",
    "seventeen": "S EH1 V AH0 N T IY1 N",
    "nineteen": "N AY1 N T IY1 N",
    "twenty": "T W EH1 N T IY0",
    "thirty": "TH ER1 T IY0",
    "forty": "F AO1 R T IY0",
    "fifty": "F IH1 F T IY0",
    "sixty": "S IH1 K S T IY0",
    "seventy": "S EH1 V AH0 N T IY0",
    "ninety": "N AY1 N T IY0",
    "hundred": "HH AH1 N D R AH0 D",
    "thousand": "TH AW1 Z AH0 N D",
    "million": "M IH1 L Y AH0 N",
    "billion": "B IH1 L Y AH0 N",
    "trillion": "T R IH1 L Y AH0 N",
    "point": "P OY1 N T",
    "minus": "M AY1 N AH0 S",
}

# ---------------------------------------------------------------------------
# letter-to-sound rules. Per first letter: list of (left, grapheme, right,
# phones). First matching rule wins; every letter ends with a catch-all.
# Context metacharacters (NRL conventions):
#   " " word boundary   "#" one or more vowels     ":" zero or more consonants
#   "^" one consonant   "." one voiced consonant   "+" front vowel (e/i/y)
#   "%" suffix (er/e/es/ed/ing/ely)  "&" sibilant  "@" t-class consonant
# Phones are stress-less ARPAbet; "" = silent.
# ---------------------------------------------------------------------------
_R: Dict[str, List[Tuple[str, str, str, str]]] = {
    "a": [
        ("", "a", " ", "AH"),
        (" ", "are", " ", "AA R"),
        (" ", "ar", "o", "AH R"),
        ("", "ar", "#", "EH R"),
        (" ^", "as", "#", "EY S"),
        ("", "a", "wa", "AH"),
        ("", "aw", "", "AO"),
        (" :", "any", "", "EH N IY"),
        ("", "a", "^+#", "EY"),
        ("#:", "ally", " ", "AH L IY"),
        (" ", "al", "#", "AH L"),
        ("", "again", "", "AH G EH N"),
        ("#:", "ag", "e", "IH JH"),
        ("", "a", "^+:#", "AE"),
        (" :", "a", "^+ ", "EY"),
        ("", "a", "^%", "EY"),
        (" ", "arr", "", "AH R"),
        ("", "arr", "", "AE R"),
        (" :", "ar", " ", "AA R"),
        ("", "ar", " ", "ER"),
        ("", "ar", "", "AA R"),
        ("", "air", "", "EH R"),
        ("", "ai", "", "EY"),
        ("", "ay", "", "EY"),
        ("", "au", "", "AO"),
        ("#:", "al", " ", "AH L"),
        ("#:", "als", " ", "AH L Z"),
        ("", "alk", "", "AO K"),
        ("", "al", "^", "AO L"),
        (" :", "able", "", "EY B AH L"),
        ("", "able", "", "AH B AH L"),
        ("", "ang", "+", "EY N JH"),
        ("", "a", "", "AE"),
    ],
    "b": [
        (" ", "be", "^#", "B IH"),
        ("", "being", "", "B IY IH NG"),
        (" ", "both", " ", "B OW TH"),
        (" ", "bus", "#", "B IH Z"),
        ("", "buil", "", "B IH L"),
        ("", "bb", "", "B"),
        ("", "b", " ", "B"),
        ("m", "b", " ", ""),  # climb, comb
        ("", "b", "", "B"),
    ],
    "c": [
        (" ", "ch", "^", "K"),  # christmas, chrome
        ("^e", "ch", "", "K"),  # tech-
        ("", "chu", "r", "CH"),
        ("", "ch", "", "CH"),
        (" s", "ci", "#", "S AY"),  # science
        ("", "ci", "a", "SH"),  # special? (c-i-a: social)
        ("", "ci", "o", "SH"),
        ("", "ci", "en", "SH"),
        ("", "cc", "+", "K S"),  # accept
        ("", "cc", "", "K"),
        ("", "ck", "", "K"),
        ("", "c", "+", "S"),
        ("", "com", "%", "K AH M"),
        ("", "c", "", "K"),
    ],
    "d": [
        ("#:", "ded", " ", "D IH D"),
        (".e", "d", " ", "D"),  # voiced + e + d: "pulled"
        ("#:^e", "d", " ", "T"),  # unvoiced + ed: "walked" -> T (approximation)
        (" ", "de", "^#", "D IH"),
        ("", "dd", "", "D"),
        ("", "d", "", "D"),
    ],
    "e": [
        ("#:", "e", " ", ""),
        ("':^", "e", " ", ""),
        (" :", "e", " ", "IY"),
        ("#", "ed", " ", "D"),
        ("#:", "e", "d ", ""),
        ("", "ev", "er", "EH V"),
        ("", "e", "^%", "IY"),
        ("", "eri", "#", "IY R IY"),
        ("", "eri", "", "EH R IH"),
        ("#:", "er", "#", "ER"),
        ("", "er", "#", "EH R"),
        ("#:", "er", " ", "ER"),
        ("", "er", "", "ER"),
        (" ", "even", "", "IY V EH N"),
        ("#:", "e", "w", ""),
        ("@", "ew", "", "UW"),
        ("", "ew", "", "Y UW"),
        ("", "e", "o", "IY"),
        ("#:&", "es", " ", "IH Z"),
        ("#:", "e", "s ", ""),
        ("#:", "ely", " ", "L IY"),
        ("#:", "ement", "", "M EH N T"),
        ("", "eful", "", "F UH L"),
        ("", "ee", "", "IY"),
        ("", "earn", "", "ER N"),
        (" ", "ear", "^", "ER"),
        ("", "ead", "", "EH D"),
        ("#:", "ea", " ", "IY AH"),
        ("", "ea", "su", "EH"),
        ("", "ea", "", "IY"),
        ("", "eigh", "", "EY"),
        ("", "ei", "", "IY"),
        (" ", "eye", "", "AY"),
        ("", "ey", "", "IY"),
        ("", "eu", "", "Y UW"),
        ("", "e", "", "EH"),
    ],
    "f": [
        ("", "ful", "", "F UH L"),
        ("", "ff", "", "F"),
        ("", "f", "", "F"),
    ],
    "g": [
        ("", "gh", "#", "G"),  # ghost; vowel follows
        (" ", "gn", "", "N"),  # gnome
        ("", "gn", " ", "N"),  # sign
        ("", "gh", "", ""),  # though/night (gh silent by default)
        (" b#", "g", "", "G"),  # begin-type: hard g
        ("", "g", "+", "JH"),  # gem, giant (approximation)
        ("", "great", "", "G R EY T"),
        ("#", "gh", "", ""),
        ("", "gg", "", "G"),
        ("", "g", "", "G"),
    ],
    "h": [
        (" ", "hav", "", "HH AE V"),
        (" ", "here", "", "HH IY R"),
        (" ", "hour", "", "AW ER"),
        ("", "how", "", "HH AW"),
        ("", "h", "#", "HH"),
        ("", "h", "", ""),
    ],
    "i": [
        (" ", "in", "", "IH N"),
        (" ", "i", " ", "AY"),
        ("", "in", "d", "AY N"),  # kind, find, mind
        ("", "ier", "", "IY ER"),
        ("#:r", "ied", "", "IY D"),
        ("", "ied", " ", "AY D"),
        ("", "ien", "", "IY EH N"),
        ("", "ie", "t", "AY EH"),
        (" :", "i", "%", "AY"),
        ("", "i", "%", "IY"),
        ("", "ie", "", "IY"),
        ("", "i", "^+:#", "IH"),
        ("", "ir", "#", "AY R"),
        ("", "iz", "%", "AY Z"),
        ("", "is", "%", "AY Z"),
        ("", "i", "d%", "AY"),
        ("+^", "i", "^+", "IH"),
        ("", "i", "t%", "AY"),
        ("#:^", "i", "^+", "IH"),
        ("", "i", "^+", "AY"),
        ("", "ir", "", "ER"),
        ("", "igh", "", "AY"),
        ("", "ild", "", "AY L D"),
        ("", "ign", " ", "AY N"),
        ("", "ign", "^", "AY N"),
        ("", "ign", "%", "AY N"),
        ("", "ique", "", "IY K"),
        ("", "ish", "", "IH SH"),
        ("", "i", "", "IH"),
    ],
    "j": [
        ("", "j", "", "JH"),
    ],
    "k": [
        (" ", "k", "n", ""),  # knee, know
        ("", "k", "", "K"),
    ],
    "l": [
        ("", "lo", "c#", "L OW"),
        ("l", "l", "", ""),
        ("#:^", "l", "%", "AH L"),
        ("", "lead", "", "L IY D"),
        ("", "l", "", "L"),
    ],
    "m": [
        ("", "mov", "", "M UW V"),
        ("", "mm", "", "M"),
        ("", "m", "", "M"),
    ],
    "n": [
        ("e", "ng", "+", "N JH"),  # danger
        ("", "ng", "r", "NG G"),
        ("", "ng", "#", "NG G"),
        ("", "ngl", "%", "NG G AH L"),
        ("", "ng", "", "NG"),
        ("", "nk", "", "NG K"),
        (" ", "now", " ", "N AW"),
        ("", "nn", "", "N"),
        ("", "n", "", "N"),
    ],
    "o": [
        ("", "of", " ", "AH V"),
        (" ", "orough", "", "ER OW"),
        ("#:", "or", " ", "ER"),
        ("#:", "ors", " ", "ER Z"),
        ("", "or", "", "AO R"),
        (" ", "one", "", "W AH N"),
        ("", "ow", " ", "OW"),
        ("", "ow", "n", "AW"),  # down, town (approximation: -own)
        ("", "ow", "", "OW"),
        (" ", "over", "", "OW V ER"),
        ("", "ov", "", "AH V"),
        ("", "o", "^%", "OW"),
        ("", "o", "^en", "OW"),
        ("", "o", "^i#", "OW"),
        ("", "ol", "d", "OW L"),
        ("", "ought", "", "AO T"),
        ("", "ough", "", "AH F"),
        (" ", "ou", "", "AW"),
        ("h", "ou", "s#", "AW"),
        ("", "ous", "", "AH S"),
        ("", "our", "", "AO R"),
        ("", "ould", "", "UH D"),
        ("^", "ou", "^l", "AH"),  # double
        ("", "oup", "", "UW P"),
        ("", "ou", "", "AW"),
        ("", "oy", "", "OY"),
        ("", "oing", "", "OW IH NG"),
        ("", "oi", "", "OY"),
        ("", "oor", "", "AO R"),
        ("", "ook", "", "UH K"),
        ("", "ood", "", "UH D"),
        ("", "oo", "", "UW"),
        ("", "o", "e", "OW"),
        ("", "o", " ", "OW"),
        ("", "oa", "", "OW"),
        (" ", "only", "", "OW N L IY"),
        (" ", "once", "", "W AH N S"),
        ("", "on't", "", "OW N T"),
        ("c", "o", "n", "AA"),
        ("", "o", "ng", "AO"),
        (" :^", "o", "n", "AH"),
        ("i", "on", "", "AH N"),
        ("#:", "on", " ", "AH N"),
        ("#^", "on", "", "AH N"),
        ("", "o", "st ", "OW"),
        ("", "of", "^", "AO F"),
        ("", "other", "", "AH DH ER"),
        ("", "oss", " ", "AO S"),
        ("#:^", "om", "", "AH M"),
        ("", "o", "", "AA"),
    ],
    "p": [
        ("", "ph", "", "F"),
        ("", "peop", "", "P IY P"),
        ("", "pow", "", "P AW"),
        ("", "put", " ", "P UH T"),
        ("", "pp", "", "P"),
        (" ", "p", "s", ""),  # psalm, psych
        (" ", "p", "n", ""),
        ("", "p", "", "P"),
    ],
    "q": [
        ("", "quar", "", "K W AO R"),
        ("", "qu", "", "K W"),
        ("", "q", "", "K"),
    ],
    "r": [
        (" ", "re", "^#", "R IY"),
        ("", "rr", "", "R"),
        ("", "r", "", "R"),
    ],
    "s": [
        ("", "sh", "", "SH"),
        ("#", "sion", "", "ZH AH N"),
        ("", "some", "", "S AH M"),
        ("#", "sur", "#", "ZH ER"),
        ("", "sur", "#", "SH ER"),
        ("#", "su", "#", "ZH UW"),
        ("#", "ssu", "#", "SH UW"),
        ("#", "sed", " ", "Z D"),
        ("#", "s", "#", "Z"),
        ("", "said", "", "S EH D"),
        ("^", "sion", "", "SH AH N"),
        ("", "ss", "", "S"),
        (".", "s", " ", "Z"),
        ("#:.e", "s", " ", "Z"),
        ("#:^#", "s", " ", "Z"),  # vowels-consonant-plural: "runs"? (approx)
        ("u", "s", " ", "S"),
        (" :#", "s", " ", "Z"),
        (" ", "sch", "", "S K"),
        ("", "s", "c+", ""),
        ("#", "sm", "", "Z M"),
        ("#", "sn", "'", "Z AH N"),
        ("", "s", "", "S"),
    ],
    "t": [
        (" ", "the", " ", "DH AH"),
        ("", "to", " ", "T UW"),
        ("", "that", " ", "DH AE T"),
        (" ", "this", " ", "DH IH S"),
        (" ", "they", "", "DH EY"),
        (" ", "there", "", "DH EH R"),
        ("", "ther", "", "DH ER"),
        ("", "their", "", "DH EH R"),
        (" ", "than", " ", "DH AE N"),
        (" ", "them", " ", "DH EH M"),
        ("", "these", " ", "DH IY Z"),
        (" ", "then", "", "DH EH N"),
        ("", "through", "", "TH R UW"),
        ("", "those", "", "DH OW Z"),
        ("", "though", " ", "DH OW"),
        (" ", "thus", "", "DH AH S"),
        ("", "th", "", "TH"),
        ("#:", "ted", " ", "T IH D"),
        ("", "ti", "on", "SH"),
        ("", "ti", "a", "SH"),
        ("", "tien", "", "SH AH N"),
        ("", "tur", "#", "CH ER"),
        ("", "tu", "a", "CH UW"),
        (" ", "two", "", "T UW"),
        ("", "tch", "", "CH"),
        ("", "tt", "", "T"),
        ("", "t", "", "T"),
    ],
    "u": [
        (" ", "un", "i", "Y UW N"),
        (" ", "un", "", "AH N"),
        (" ", "upon", "", "AH P AO N"),
        ("@", "ur", "#", "UH R"),
        ("", "ur", "#", "Y UH R"),
        ("", "ur", "", "ER"),
        ("", "u", "^ ", "AH"),
        ("", "u", "^^", "AH"),
        ("", "uy", "", "AY"),
        (" g", "u", "#", ""),
        ("g", "u", "%", ""),
        ("g", "u", "#", "W"),
        ("#n", "u", "", "Y UW"),
        ("@", "u", "", "UW"),
        ("", "u", "", "Y UW"),
    ],
    "v": [
        ("", "view", "", "V Y UW"),
        ("", "v", "", "V"),
    ],
    "w": [
        (" ", "were", "", "W ER"),
        ("", "wa", "sh", "W AA"),
        ("", "wa", "st", "W EY"),
        ("", "wa", "s", "W AA"),
        ("", "wa", "t", "W AA"),
        ("", "where", "", "W EH R"),
        ("", "what", "", "W AH T"),
        ("", "whol", "", "HH OW L"),
        ("", "who", "", "HH UW"),
        ("", "wh", "", "W"),
        ("", "war", "#", "W EH R"),
        ("", "war", "", "W AO R"),
        ("", "wor", "^", "W ER"),
        ("", "wr", "", "R"),
        ("", "w", "", "W"),
    ],
    "x": [
        (" ", "x", "", "Z"),  # xylophone
        ("", "x", "", "K S"),
    ],
    "y": [
        ("", "young", "", "Y AH NG"),
        (" ", "you", "", "Y UW"),
        (" ", "yes", "", "Y EH S"),
        (" ", "y", "", "Y"),
        ("#:^", "y", " ", "IY"),
        ("#:^", "y", "i", "IY"),
        (" :", "y", " ", "AY"),
        (" :", "y", "#", "AY"),
        (" :", "y", "^+:#", "IH"),
        (" :", "y", "^#", "AY"),
        ("", "y", "", "IH"),
    ],
    "z": [
        ("", "zz", "", "Z"),
        ("", "z", "", "Z"),
    ],
    "'": [
        ("#:", "'s", " ", "Z"),
        ("", "'s", " ", "Z"),
        ("", "'", "", ""),
    ],
}


def _is_vowel(c: str) -> bool:
    return c in _VOWELS


def _match_left(pattern: str, text: str) -> bool:
    """Match ``pattern`` (right-to-left) against the end of ``text``."""
    i = len(text)
    for p in reversed(pattern):
        if p == " ":
            if i != 0 and not text[:i].endswith(" "):
                return False
            i -= 1 if i > 0 else 0
        elif p == "#":
            if i == 0 or not _is_vowel(text[i - 1]):
                return False
            i -= 1
            while i > 0 and _is_vowel(text[i - 1]):
                i -= 1
        elif p == ":":
            while i > 0 and text[i - 1].isalpha() and not _is_vowel(text[i - 1]):
                i -= 1
        elif p == "^":
            if i == 0 or _is_vowel(text[i - 1]) or not text[i - 1].isalpha():
                return False
            i -= 1
        elif p == ".":
            if i == 0 or text[i - 1] not in _VOICED:
                return False
            i -= 1
        elif p == "+":
            if i == 0 or text[i - 1] not in _FRONT:
                return False
            i -= 1
        elif p == "&":
            if i >= 2 and text[i - 2 : i] in ("ch", "sh"):
                i -= 2
            elif i > 0 and text[i - 1] in _SIBILANT_1:
                i -= 1
            else:
                return False
        elif p == "@":
            if i >= 2 and text[i - 2 : i] in ("th", "ch", "sh"):
                i -= 2
            elif i > 0 and text[i - 1] in _T_CLASS_1:
                i -= 1
            else:
                return False
        else:  # literal
            if i == 0 or text[i - 1] != p:
                return False
            i -= 1
    return True


def _match_right(pattern: str, text: str) -> bool:
    """Match ``pattern`` (left-to-right) against the start of ``text``."""
    i = 0
    n = len(text)
    for p in pattern:
        if p == " ":
            if i < n and text[i] != " ":
                return False
            i += 1
        elif p == "#":
            if i >= n or not _is_vowel(text[i]):
                return False
            i += 1
            while i < n and _is_vowel(text[i]):
                i += 1
        elif p == ":":
            while i < n and text[i].isalpha() and not _is_vowel(text[i]):
                i += 1
        elif p == "^":
            if i >= n or _is_vowel(text[i]) or not text[i].isalpha():
                return False
            i += 1
        elif p == ".":
            if i >= n or text[i] not in _VOICED:
                return False
            i += 1
        elif p == "+":
            if i >= n or text[i] not in _FRONT:
                return False
            i += 1
        elif p == "%":
            for suf in ("ing", "ely", "er", "es", "ed", "e"):
                if text[i : i + len(suf)] == suf:
                    i += len(suf)
                    break
            else:
                return False
        elif p == "&":
            if text[i : i + 2] in ("ch", "sh"):
                i += 2
            elif i < n and text[i] in _SIBILANT_1:
                i += 1
            else:
                return False
        elif p == "@":
            if text[i : i + 2] in ("th", "ch", "sh"):
                i += 2
            elif i < n and text[i] in _T_CLASS_1:
                i += 1
            else:
                return False
        else:
            if i >= n or text[i] != p:
                return False
            i += 1
    return True


def letter_to_sound(word: str) -> List[str]:
    """Apply the rule table to one lowercase word; stress-less ARPAbet."""
    text = f" {word} "
    phones: List[str] = []
    i = 1
    end = len(text) - 1
    while i < end:
        c = text[i]
        rules = _R.get(c)
        if rules is None:
            i += 1  # unknown char (digits already expanded): skip
            continue
        for left, match, right, out in rules:
            j = i + len(match)
            if text[i:j] != match:
                continue
            if not _match_left(left, text[:i]):
                continue
            if not _match_right(right, text[j:]):
                continue
            if out:
                phones.extend(out.split())
            i = j
            break
        else:  # no rule matched (catch-alls should prevent this)
            i += 1
    return phones


def _apply_stress(phones: Sequence[str]) -> List[str]:
    """First vowel gets primary stress, the rest get 0 (heuristic)."""
    out: List[str] = []
    stressed = False
    for p in phones:
        if p in ARPABET_VOWELS:
            out.append(p + ("0" if stressed else "1"))
            stressed = True
        else:
            out.append(p)
    return out


# ---------------------------------------------------------------------------
# number expansion (replaces inflect.engine().number_to_words)
# ---------------------------------------------------------------------------
_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    (10 ** 12, "trillion"),
    (10 ** 9, "billion"),
    (10 ** 6, "million"),
    (10 ** 3, "thousand"),
    (100, "hundred"),
]


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, rest = divmod(n, 10)
        return _TENS[tens] + (" " + _ONES[rest] if rest else "")
    for scale, name in _SCALES:
        if n >= scale:
            major, rest = divmod(n, scale)
            words = number_to_words(major) + " " + name
            if rest:
                words += " " + number_to_words(rest)
            return words
    return _ONES[0]  # unreachable


def _expand_number(tok: str) -> str:
    tok = tok.replace(",", "")
    if "." in tok:
        whole, _, frac = tok.partition(".")
        parts = [number_to_words(int(whole))] if whole else []
        if frac:
            parts.append("point")
            parts.extend(_ONES[int(d)] for d in frac if d.isdigit())
        return " ".join(parts)
    return number_to_words(int(tok))


_NUM_RE = re.compile(r"\d[\d,]*(?:\.\d+)?")
_KEEP_RE = re.compile(r"[^a-z' ]")


def normalize_text(text: str) -> List[str]:
    """Lowercase, expand numbers, strip to [a-z'], split into words."""
    text = unicodedata.normalize("NFKD", text)
    text = text.encode("ascii", "ignore").decode("ascii").lower()
    text = _NUM_RE.sub(lambda m: " " + _expand_number(m.group(0)) + " ", text)
    text = _KEEP_RE.sub(" ", text)
    return [w.strip("'") for w in text.split() if w.strip("'")]


class NativeEnglishG2p:
    """Callable mirroring ``g2p_en.G2p``: text -> ARPAbet tokens with
    stress digits and ``" "`` word separators."""

    def __init__(self, lexicon: Dict[str, str] | None = None):
        self.lexicon = dict(_LEXICON)
        if lexicon:
            self.lexicon.update(lexicon)

    def word2phones(self, word: str) -> List[str]:
        hit = self.lexicon.get(word)
        if hit is not None:
            return hit.split()
        # simple suffix fallback keeps lexicon coverage for inflections
        if word.endswith("'s") and word[:-2] in self.lexicon:
            base = self.lexicon[word[:-2]].split()
            if base[-1] in ("S", "Z", "SH", "CH", "ZH", "JH"):
                return base + ["IH0", "Z"]
            if base[-1] in ("P", "T", "K", "F", "TH"):
                return base + ["S"]
            return base + ["Z"]
        return _apply_stress(letter_to_sound(word))

    def __call__(self, text: str) -> List[str]:
        phones: List[str] = []
        for w, word in enumerate(normalize_text(text)):
            if w > 0:
                phones.append(" ")
            phones.extend(self.word2phones(word))
        return phones
