"""Text front end of the PyTorch port (a copy of seq2seq_vc_tpu/text):
cleaners, tokenizers (char, word, phoneme with the native English G2P and
the lazily imported third-party backends) and token-id conversion."""

from .cleaner import TextCleaner  # noqa: F401
from .tokenizers import (  # noqa: F401
    AbsTokenizer,
    CharTokenizer,
    PhonemeTokenizer,
    WordTokenizer,
    build_tokenizer,
)
from .token_id_converter import TokenIDConverter  # noqa: F401
