#!/usr/bin/env python3
"""Fixtures for the synthetic Urhythmic recipe on the PyTorch port
(``scripts/run_synth_urhythmic_torch.sh``, stage 0), with no JAX, sklearn
or transformers:

* two "speakers" under ``<workdir>/{src,trg}/<wav-subdir>`` (harmonic
  tones at 110 and 220 Hz with silent edges, a mid gap and amplitude
  modulation, as ``egs/synth/urhythmic/local/make_fixtures.py`` makes them
  at 16 kHz), at ``--sample-rate``;
* a seeded HuBERT-soft checkpoint in bshall/hubert's naming (the port's
  ``HubertSoft`` at hubert-base widths, its soft head drawn from a seed);
* a segmenter checkpoint: the port's Ward clustering fitted on that
  checkpoint's label embedding, with a fixed sound-type assignment.

The weights are random, so the outputs are not speech, but every stage's
code runs end to end.

    python3 scripts/make_synth_urhythmic_fixtures.py --workdir DIR [--n-utts 6] \
        [--sample-rate 16000] [--wav-subdir wav16k]
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))


def make_wavs(out_dir: str, f0: float, n_utts: int, seed: int, sr: int = 16000):
    from seq2seq_vc_torch.utils.audio import write_wav

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n_utts):
        dur = 1.0 + 0.4 * rng.random()
        t = np.arange(int(sr * dur)) / sr
        phase = 2 * np.pi * f0 * (1.0 + 0.02 * np.sin(2 * np.pi * 3 * t)) * t
        x = sum(0.5 ** k * np.sin((k + 1) * phase) for k in range(4))
        env = np.minimum(1.0, 20 * t) * np.minimum(1.0, 20 * (t[-1] - t))
        gap_c = 0.4 + 0.3 * rng.random()
        env *= 1.0 - 0.95 * np.exp(-(((t - gap_c) / 0.03) ** 2))
        x = 0.3 * x * env + 0.002 * rng.standard_normal(t.size)
        write_wav(os.path.join(out_dir, f"utt{i:03d}.wav"), x.astype(np.float32), sr)


def make_hubert_ckpt(path: str, seed: int = 0) -> np.ndarray:
    """A seeded ``HubertSoft`` state dict (bshall naming) at ``path``;
    returns its label embedding (100, 256)."""
    import torch

    from seq2seq_vc_torch.urhythmic.hubert import HubertSoft

    torch.manual_seed(seed)
    sd = HubertSoft().state_dict()
    g = torch.Generator().manual_seed(seed + 1)
    sd["proj.weight"] = 0.02 * torch.randn(256, 768, generator=g)
    sd["proj.bias"] = torch.zeros(256)
    sd["label_embedding.weight"] = torch.randn(100, 256, generator=g)
    torch.save(sd, path)
    return sd["label_embedding.weight"].numpy()


def make_segmenter_ckpt(path: str, codebook: np.ndarray) -> None:
    from seq2seq_vc_torch.urhythmic.segmenter import Segmenter
    from seq2seq_vc_torch.urhythmic.utils import OBSTRUENT, SILENCE, SONORANT

    seg = Segmenter(num_clusters=3, gamma=2)
    seg.cluster(codebook)
    # random weights carry no phonetics: any consistent assignment will do
    seg.sound_types = {0: SILENCE, 1: SONORANT, 2: OBSTRUENT}
    with open(path, "wb") as f:
        pickle.dump(seg.state_dict(), f)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--n-utts", type=int, default=6)
    ap.add_argument("--sample-rate", type=int, default=16000)
    ap.add_argument("--wav-subdir", default="wav16k")
    args = ap.parse_args(argv)
    for spk, f0, seed in (("src", 110.0, 0), ("trg", 220.0, 1)):
        make_wavs(os.path.join(args.workdir, spk, args.wav_subdir), f0, args.n_utts, seed,
                  args.sample_rate)
    downloads = os.path.join(args.workdir, "downloads")
    os.makedirs(downloads, exist_ok=True)
    codebook = make_hubert_ckpt(os.path.join(downloads, "hubert_soft_random.pt"))
    make_segmenter_ckpt(os.path.join(downloads, "segmenter.pkl"), codebook)
    print("fixtures ready under", args.workdir)


if __name__ == "__main__":
    main()
