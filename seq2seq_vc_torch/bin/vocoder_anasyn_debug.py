"""Vocoder analysis-synthesis check (mirrors
seq2seq_vc_tpu/bin/vocoder_anasyn_debug.py:1-73).

    python -m seq2seq_vc_torch.bin.vocoder_anasyn_debug --rootdir wavs \
        --config conf.yaml --outdir anasyn [--stats stats.npz --feat-type mel]

Extracts the log-mel of each wav (``--wav-scp`` or every ``*.wav`` under
``--rootdir``) with the config's feature settings and re-synthesises it at
once through the config's vocoder (``vocoder/vocoder.py``), which isolates
the vocoder from the VC model. With ``--stats`` the features are
normalised before the vocoder, which de-normalises them again. Writes
``<outdir>/<utt>.wav``; returns the utterances, the seconds of audio, the
vocoder's seconds and its real-time factor.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

from ..core.config import load_config
from ..device import resolve_device
from ..dsp.features import logmelfilterbank
from ..dsp.stats import normalize
from ..train.data import read_scp
from ..utils.audio import read_wav, write_wav
from ..utils.io import find_files, read_stats
from ..vocoder.vocoder import get_vocoder
from . import setup


def find_wavs(rootdir: str):
    """(utt_id, path) of every ``*.wav`` under ``rootdir``, sorted by path."""
    return [(os.path.splitext(os.path.basename(p))[0], p)
            for p in sorted(find_files(rootdir, "*.wav"))]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Vocoder analysis-synthesis check")
    parser.add_argument("--wav-scp", default=None)
    parser.add_argument("--rootdir", default=None, help="wav directory (without --wav-scp)")
    parser.add_argument("--config", required=True)
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--stats", default=None, help="normalise features before vocoding")
    parser.add_argument("--feat-type", default="mel")
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup(args.verbose)
    device = resolve_device(args.device)
    config = load_config(args.config)
    sr = config["sampling_rate"]
    stats = read_stats(args.stats, args.feat_type) if args.stats else None
    vocoder = get_vocoder(config, stats, device)
    items = list(read_scp(args.wav_scp).items()) if args.wav_scp else find_wavs(args.rootdir)

    os.makedirs(args.outdir, exist_ok=True)
    audio_sec, voc_sec = 0.0, 0.0
    for utt, path in items:
        audio, in_sr = read_wav(path)
        if in_sr != sr:
            raise ValueError(f"{utt}: expected {sr} Hz, got {in_sr}")
        mel = logmelfilterbank(audio, sr, fft_size=config["fft_size"],
                               hop_size=config["hop_size"], win_length=config.get("win_length"),
                               num_mels=config["num_mels"], fmin=config.get("fmin"),
                               fmax=config.get("fmax"), device=device)
        if stats is not None:
            mel = normalize(mel, stats["mean"], stats["scale"])
        start = time.perf_counter()
        y = vocoder.decode(mel)
        voc_sec += time.perf_counter() - start
        audio_sec += len(audio) / sr
        write_wav(os.path.join(args.outdir, f"{utt}.wav"), y, sr)
    rtf = voc_sec / max(audio_sec, 1e-9)
    logging.info("%d utterances, %.2f s of audio, vocoder %.3f s (RTF %.5f)", len(items),
                 audio_sec, voc_sec, rtf)
    return {"utterances": len(items), "audio_seconds": audio_sec, "seconds": voc_sec,
            "rtf": rtf}


if __name__ == "__main__":
    main()
