"""Urhythmic's recipe stages on the port (mirrors
seq2seq_vc_tpu/urhythmic/cli.py), as subcommands of

    python -m seq2seq_vc_torch.urhythmic.cli <cmd> ... [--device cpu]

``resample``, ``encode`` (HuBERT-soft units and log-probs), ``segment``,
``train-rhythm-model``, ``fine-tune-vocoder`` and ``convert``, with the JAX
CLI's flags. Every subcommand runs on the card unless ``--device`` names
another device, and raises without a card otherwise. ``encode`` reads a
local HuBERT-soft checkpoint (bshall or HF naming); ``hub`` loads
bshall/hubert through ``torch.hub``, which needs the network.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle
import time

import numpy as np

from ..bin import setup
from ..device import resolve_device
from ..utils.audio import read_wav, resample, write_wav
from ..utils.io import find_files, get_basename
from .hubert import UNITS_PAD, HubertSoft, conv_stack_frames, encode_batch, load_hubert_soft
from .model import UrhythmicFine, encode
from .rhythm_model import RhythmModelFineGrained
from .segmenter import Segmenter
from .stretcher import TimeStretcherFineGrained
from .utils import SoundType

BUCKET = 16000  # the encode batches' sample quantum: 1 s


def _load_hubert(checkpoint: str, device):
    """bshall/hubert from torch hub (``hub``), or a checkpoint file in the
    port's ``HubertSoft``."""
    if checkpoint == "hub":
        import torch

        return torch.hub.load("bshall/hubert:main", "hubert_soft",
                              trust_repo=True).eval().to(device)
    return load_hubert_soft(checkpoint, device)


def cmd_encode(args):
    hubert = _load_hubert(args.hubert_checkpoint, args.device)
    for sub in ("soft", "logprobs"):
        os.makedirs(os.path.join(args.out_dir, sub), exist_ok=True)
    items = []
    for path in sorted(find_files(args.in_dir, "*.wav")):
        wav, sr = read_wav(path)
        if sr != 16000:
            raise ValueError(f"{path}: {sr} Hz; urhythmic operates at 16 kHz")
        items.append((get_basename(path), wav))

    def save(utt, units, log_probs):
        np.save(os.path.join(args.out_dir, "soft", f"{utt}.npy"), units)
        np.save(os.path.join(args.out_dir, "logprobs", f"{utt}.npy"), log_probs)

    if not isinstance(hubert, HubertSoft):
        for utt, wav in items:
            save(utt, *encode(hubert, wav))
        return
    # same-bucket utterances ride one masked (B, T) forward
    groups = {}
    for utt, wav in items:
        groups.setdefault(-(-len(wav) // BUCKET) * BUCKET, []).append((utt, wav))
    for tb, members in sorted(groups.items()):
        for i in range(0, len(members), args.batch_size):
            chunk = members[i: i + args.batch_size]
            wavs = np.zeros((len(chunk), tb), np.float32)
            lens = np.zeros((len(chunk),), np.int64)
            for bi, (_, w) in enumerate(chunk):
                wavs[bi, : len(w)] = w
                lens[bi] = len(w)
            units, log_probs, _ = encode_batch(hubert, wavs, BUCKET, lens)
            units, log_probs = units.cpu().numpy(), log_probs.cpu().numpy()
            for bi, (utt, w) in enumerate(chunk):
                n = int(conv_stack_frames(len(w) + 2 * UNITS_PAD))
                save(utt, units[bi, :n], log_probs[bi, :n])


def _load_segmenter(path: str, gamma: float) -> Segmenter:
    seg = Segmenter(num_clusters=3, gamma=gamma)
    with open(path, "rb") as f:
        seg.load_state_dict(pickle.load(f))
    return seg


def cmd_segment(args):
    seg = _load_segmenter(args.segmenter_checkpoint, args.gamma)
    os.makedirs(args.out_dir, exist_ok=True)
    for path in sorted(find_files(args.logprob_dir, "*.npy")):
        clusters, boundaries = seg(np.load(path))
        np.savez(os.path.join(args.out_dir, f"{get_basename(path)}.npz"),
                 segments=np.asarray([c.value for c in clusters]),
                 boundaries=np.asarray(boundaries))


def _load_segments(seg_dir):
    utts = []
    for path in sorted(find_files(seg_dir, "*.npz")):
        data = np.load(path)
        utts.append(([SoundType(int(v)) for v in data["segments"]], list(data["boundaries"])))
    return utts


def cmd_train_rhythm_model(args):
    rm = RhythmModelFineGrained(hop_length=args.hop_length, sample_rate=args.sample_rate)
    if args.source_segments:
        rm.fit_source(_load_segments(args.source_segments))
    if args.target_segments:
        rm.fit_target(_load_segments(args.target_segments))
    with open(args.out_path, "wb") as f:
        pickle.dump(rm.state_dict(), f)
    logging.info("saved rhythm model to %s", args.out_path)


def cmd_fine_tune_vocoder(args):
    """Returns each step's losses and ``step_ms`` (host time of the step,
    which ends in a fetch of the losses)."""
    from .dataset import MelDataset
    from .vocoder_train import BATCH_SIZE, HifiganTrainer

    trainer = HifiganTrainer(device=args.device)
    dataset = MelDataset(args.wav_dir, args.unit_dir, train=True)
    if args.resume:
        trainer.load(args.resume, finetune=args.finetune)
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    logging.info("fine-tuning on %d utterances", len(dataset))
    history = []
    while trainer.steps < args.steps:
        for batch in dataset.batches(min(BATCH_SIZE, len(dataset))):
            t0 = time.perf_counter()
            metrics = trainer.train_step(batch["units"], batch["wav"])
            history.append(dict(metrics, step=trainer.steps,
                                step_ms=(time.perf_counter() - t0) * 1e3))
            if trainer.steps % args.log_interval == 0:
                logging.info("step %d: gen=%.3f disc=%.3f mel=%.3f (%.1f ms)", trainer.steps,
                             metrics["loss_generator"], metrics["loss_discriminator"],
                             metrics["loss_mel"], history[-1]["step_ms"])
            if trainer.steps % args.checkpoint_interval == 0:
                trainer.save(os.path.join(args.checkpoint_dir, f"model-{trainer.steps}.ckpt"))
            if trainer.steps >= args.steps:
                break
    trainer.save(os.path.join(args.checkpoint_dir, f"model-{trainer.steps}.ckpt"))
    return history


def cmd_convert(args):
    from ..vocoder.hifigan import load_hifigan_backend

    seg = _load_segmenter(args.segmenter_checkpoint, args.gamma)
    rm = RhythmModelFineGrained()
    with open(args.rhythm_model_checkpoint, "rb") as f:
        rm.load_state_dict(pickle.load(f))
    vocoder_fn = load_hifigan_backend(args.vocoder_checkpoint, args.vocoder_config, args.device)
    system = UrhythmicFine(seg, rm, TimeStretcherFineGrained(), vocoder_fn)
    os.makedirs(args.out_dir, exist_ok=True)
    for upath in sorted(find_files(os.path.join(args.in_dir, "soft"), "*.npy")):
        utt = get_basename(upath)
        log_probs = np.load(os.path.join(args.in_dir, "logprobs", f"{utt}.npy"))
        wav = system(np.load(upath), log_probs)
        write_wav(os.path.join(args.out_dir, f"{utt}.wav"), wav, 16000)
        logging.info("converted %s (%d samples)", utt, len(wav))


def cmd_resample(args):
    os.makedirs(args.out_dir, exist_ok=True)
    for path in sorted(find_files(args.in_dir, "*.wav")):
        wav, sr = read_wav(path)
        if wav.ndim > 1:
            wav = wav.mean(axis=1)
        write_wav(os.path.join(args.out_dir, os.path.basename(path)),
                  resample(wav, sr, args.sample_rate), args.sample_rate)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Urhythmic rhythm conversion tools (PyTorch port)")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default=None, help="torch device (default: the card)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("encode", parents=[common])
    p.add_argument("--in-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--hubert-checkpoint", default="hub")
    p.add_argument("--batch-size", type=int, default=8,
                   help="same-bucket utterances encoded in one forward")
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("segment", parents=[common])
    p.add_argument("--logprob-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--segmenter-checkpoint", required=True)
    p.add_argument("--gamma", type=float, default=2)
    p.set_defaults(fn=cmd_segment)

    p = sub.add_parser("train-rhythm-model", parents=[common])
    p.add_argument("--source-segments", default=None)
    p.add_argument("--target-segments", default=None)
    p.add_argument("--out-path", required=True)
    p.add_argument("--hop-length", type=int, default=320)
    p.add_argument("--sample-rate", type=int, default=16000)
    p.set_defaults(fn=cmd_train_rhythm_model)

    p = sub.add_parser("fine-tune-vocoder", parents=[common])
    p.add_argument("--wav-dir", required=True)
    p.add_argument("--unit-dir", required=True)
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--resume", default=None)
    p.add_argument("--finetune", action="store_true")
    p.add_argument("--steps", type=int, default=50000)
    p.add_argument("--log-interval", type=int, default=25)
    p.add_argument("--checkpoint-interval", type=int, default=10000)
    p.set_defaults(fn=cmd_fine_tune_vocoder)

    p = sub.add_parser("convert", parents=[common])
    p.add_argument("--in-dir", required=True, help="dir with soft/ and logprobs/")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--segmenter-checkpoint", required=True)
    p.add_argument("--rhythm-model-checkpoint", required=True)
    p.add_argument("--vocoder-checkpoint", required=True)
    p.add_argument("--vocoder-config", default=None)
    p.add_argument("--gamma", type=float, default=2)
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("resample", parents=[common])
    p.add_argument("--in-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--sample-rate", type=int, default=16000)
    p.set_defaults(fn=cmd_resample)
    return parser


def main(argv=None):
    """Runs one subcommand; returns what it returns (``fine-tune-vocoder``:
    its step history)."""
    args = build_parser().parse_args(argv)
    setup(1)
    args.device = resolve_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    main()
