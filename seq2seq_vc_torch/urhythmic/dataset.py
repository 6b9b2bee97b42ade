"""Urhythmic vocoder-training dataset (a copy of
seq2seq_vc_tpu/urhythmic/dataset.py): random aligned (soft-units, wav)
segments for GAN training, drawn with numpy's ``default_rng(seed)`` as the
JAX package draws them, so both give the same batches from a directory."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from ..utils.audio import read_wav
from ..utils.io import find_files, get_basename
from .vocoder_train import HOP_LENGTH, SEGMENT_LENGTH


class MelDataset:
    """Pairs <utt>.npy soft units with <utt>.wav waveforms."""

    def __init__(
        self,
        wav_dir: str,
        unit_dir: str,
        segment_length: int = SEGMENT_LENGTH,
        hop_length: int = HOP_LENGTH,
        train: bool = True,
        seed: int = 0,
    ):
        wavs = {get_basename(p): p for p in find_files(wav_dir, "*.wav")}
        units = {get_basename(p): p for p in find_files(unit_dir, "*.npy")}
        self.utt_ids = sorted(set(wavs) & set(units))
        if not self.utt_ids:
            raise ValueError("no paired wav/unit files found")
        self.wavs = wavs
        self.units = units
        self.segment_length = segment_length
        self.hop_length = hop_length
        self.train = train
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.utt_ids)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        utt = self.utt_ids[idx]
        wav, _ = read_wav(self.wavs[utt])
        units = np.load(self.units[utt]).astype(np.float32)  # (T, D)

        frames_per_segment = math.floor(self.segment_length / self.hop_length)
        if self.train and units.shape[0] > frames_per_segment:
            offset = int(self.rng.integers(0, units.shape[0] - frames_per_segment))
        else:
            offset = 0
        useg = units[offset : offset + frames_per_segment]
        wseg = wav[offset * self.hop_length : offset * self.hop_length + self.segment_length]
        if useg.shape[0] < frames_per_segment:
            pad = frames_per_segment - useg.shape[0]
            useg = np.concatenate(
                [useg, np.full((pad, useg.shape[1]), useg.mean(), np.float32)]
            )
        if len(wseg) < self.segment_length:
            wseg = np.pad(wseg, (0, self.segment_length - len(wseg)))
        return {"utt_id": utt, "units": useg, "wav": wseg.astype(np.float32)}

    def batches(self, batch_size: int, shuffle: bool = True):
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            items = [self[int(j)] for j in order[i : i + batch_size]]
            yield {
                "units": np.stack([it["units"] for it in items]),
                "wav": np.stack([it["wav"] for it in items]),
            }
