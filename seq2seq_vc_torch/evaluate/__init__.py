"""Objective evaluation (mirrors seq2seq_vc_tpu/evaluate/): MCD, F0 RMSE and
correlation, duration difference (host numpy), and CER/WER through the
port's wav2vec2 for CTC on the card."""

from .asr import character_error_rate, levenshtein, word_error_rate  # noqa: F401
from .dtw import dtw_path  # noqa: F401
from .dtw_based import calculate_mcd_f0  # noqa: F401
