"""WAV read/write through ``scipy.io.wavfile`` and polyphase resampling (a
copy of seq2seq_vc_tpu/utils/audio.py:21-37 and
seq2seq_vc_tpu/bin/preprocess.py:32-41).

Integer PCM reads as float32 in [-1, 1]; float audio writes as PCM16.
"""

from __future__ import annotations

from math import gcd

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

_PCM_SCALE = {
    np.dtype(np.int16): 2 ** 15,
    np.dtype(np.int32): 2 ** 31,
    np.dtype(np.uint8): 2 ** 7,
}


def read_wav(path: str):
    """A wav file -> (float32 audio in [-1, 1] of shape (T,) or (T, C), rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    elif data.dtype in _PCM_SCALE:
        audio = data.astype(np.float32) / _PCM_SCALE[data.dtype]
    else:
        audio = data.astype(np.float32)
    return audio, sr


def write_wav(path: str, audio: np.ndarray, sr: int) -> None:
    """Write float audio in [-1, 1] as PCM16."""
    audio = np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
    wavfile.write(path, sr, (audio * (2 ** 15 - 1)).astype(np.int16))


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling from ``orig_sr`` to ``target_sr``."""
    if orig_sr == target_sr:
        return audio
    g = gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g).astype(np.float32)
