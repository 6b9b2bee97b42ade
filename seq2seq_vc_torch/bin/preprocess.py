"""Feature extraction: wav -> per-utterance features in a dump directory
(mirrors seq2seq_vc_tpu/bin/preprocess.py).

    python -m seq2seq_vc_torch.bin.preprocess --wav-scp wav.scp \
        --dumpdir dump/raw --config conf.yaml [--segments segments] [--device cpu]

Reads a kaldi-style ``wav.scp`` (with ``--segments``, kaldi's ``utt_id
rec_id start end`` lines cut utterances out of its recordings), takes the
channel mean, resamples to ``sampling_rate``, trims silence
(``trim_silence``), applies ``global_gain_scale`` (warning where that
clips) and extracts the log-mel, which is always written, and each other
type in ``feat_list``: ``ppg_sxliu`` (``encoders/ppg.py``, at 16 kHz),
``encodec`` (``encoders/encodec.py``, at 24 kHz) and ``hubert``
(``urhythmic/hubert.py``, at 16 kHz: ``layer: N`` or ``feature:
units``). The wave is padded to ``len(mel) * hop_size`` samples and
written too, as ``wave``. The extraction runs on the card unless
``--device`` names another device.

Storage is the config's ``format``: ``hdf5`` (the default, what the JAX
CLI writes: ``<dumpdir>/<utt>.h5`` with one dataset a type) or ``npy``
(``<dumpdir>/<type>/<utt>.npy`` and ``<dumpdir>/<type>.scp``, which needs
no ``h5py``). ``main`` returns the utterances, the seconds of audio and the
seconds each feature type took.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Any, Callable, Dict

import numpy as np

from ..core.config import load_config
from ..device import resolve_device
from ..dsp.features import LogMelExtractor
from ..train.data import read_scp
from ..utils.audio import read_wav, resample
from ..utils.io import DumpWriter
from . import setup

FEAT_TYPES = ("mel", "encodec", "hubert", "ppg_sxliu")


def trim_silence(audio: np.ndarray, threshold_in_db: float = 60.0, frame_size: int = 2048,
                 hop_size: int = 512) -> np.ndarray:
    """Leading and trailing frames whose RMS lies more than
    ``threshold_in_db`` under the loudest frame's cut off
    (``librosa.effects.trim``'s rule; seq2seq_vc_tpu/bin/preprocess.py:44-64)."""
    if len(audio) < frame_size:
        return audio
    n = 1 + (len(audio) - frame_size) // hop_size
    idx = np.arange(n)[:, None] * hop_size + np.arange(frame_size)[None, :]
    rms = np.sqrt(np.mean(audio[idx] ** 2, axis=1))
    db = 20.0 * np.log10(np.maximum(rms, 1e-10))
    keep = db > (db.max() - threshold_in_db)
    if not keep.any():
        return audio
    first, last = np.argmax(keep), len(keep) - 1 - np.argmax(keep[::-1])
    return audio[first * hop_size: min(len(audio), last * hop_size + frame_size)]


def read_segments(path: str) -> Dict[str, tuple]:
    """{utt_id: (rec_id, start s, end s)} of a kaldi ``segments`` file."""
    segments = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 4:
                utt, rec, start, end = parts
                segments[utt] = (rec, float(start), float(end))
    return segments


def hubert_extractor(model, sr: int, layer=None, units: bool = False) -> Callable:
    """wav at ``sr`` -> HuBERT features at 50 Hz (the JAX CLI's, its
    seq2seq_vc_tpu/bin/preprocess.py:120-157,255-267): layer ``layer``'s
    hidden states (768 wide; the last layer's without one) or, with
    ``units``, the soft units (256 wide). The 16 kHz wave is zero-padded to
    a 5120-sample bucket and the model runs masked to its length, which
    gives the exact-length features on the valid frames."""
    import torch

    from ..urhythmic.hubert import UNITS_PAD, conv_stack_frames

    device = model.proj.weight.device

    @torch.no_grad()
    def extract(wav: np.ndarray) -> np.ndarray:
        wav16 = resample(wav, sr, 16000)
        n_frames = max(int(conv_stack_frames(len(wav16) + (2 * UNITS_PAD if units else 0))), 1)
        padded = torch.from_numpy(np.pad(wav16, (0, -len(wav16) % 5120))[None]).to(device)
        lens = torch.tensor([len(wav16)], device=device)
        feat = (model.units(padded, lens) if units
                else model.encode(padded, layer, lens))
        return feat[0, :n_frames].float().cpu().numpy()

    return extract


def build_extractors(config: Dict[str, Any], device) -> Dict[str, Callable]:
    """{type: wav at ``sampling_rate`` -> (frames, dim) float32} for the
    log-mel and each other type of the config's ``feat_list``; the
    refusals of the JAX CLI."""
    sr = config["sampling_rate"]
    feat_list = config.get("feat_list", {"mel": {}})
    extractors = {"mel": LogMelExtractor(
        sr, config["fft_size"], config["hop_size"], config.get("win_length"),
        config.get("window", "hann"), config["num_mels"], config.get("fmin"),
        config.get("fmax"), device=device)}
    if "encodec" in feat_list:
        ckpt = (feat_list["encodec"] or {}).get("checkpoint") or config.get("encodec_checkpoint")
        if not ckpt:
            raise ValueError("feat_list.encodec needs `checkpoint:` (a torch EnCodec "
                             "state_dict, HF transformers or facebookresearch naming)")
        from ..encoders.encodec import SAMPLE_RATE, encode, load_encodec

        encoder = load_encodec(ckpt, device)
        extractors["encodec"] = lambda wav: encode(encoder, resample(wav, sr, SAMPLE_RATE)
                                                   ).cpu().numpy()
    if "hubert" in feat_list:
        hcfg = feat_list["hubert"] or {}
        ckpt = hcfg.get("checkpoint") or config.get("hubert_checkpoint")
        if not ckpt:
            raise ValueError("feat_list.hubert needs `checkpoint:` (a torch HuBERT state_dict, "
                             "HF transformers or bshall naming)")
        from ..urhythmic.hubert import load_hubert_soft

        extractors["hubert"] = hubert_extractor(
            load_hubert_soft(ckpt, device), sr, hcfg.get("layer"),
            hcfg.get("feature", "layer") == "units")
    if "ppg_sxliu" in feat_list:
        pcfg = feat_list["ppg_sxliu"] or {}
        if not pcfg.get("checkpoint") or not pcfg.get("upstream_checkpoint"):
            raise ValueError(
                "feat_list.ppg_sxliu needs `checkpoint:` (s3prl-vc downstream ckpt with the "
                "trained featurizer) AND `upstream_checkpoint:` (the espnet-style PPG "
                "conformer weights)")
        from ..encoders.ppg import build_extractor

        ppg = build_extractor(pcfg["upstream_checkpoint"], pcfg["checkpoint"],
                              sample_rate=16000, input_dim=pcfg.get("input_dim"), device=device)
        extractors["ppg_sxliu"] = lambda wav: ppg(resample(wav, sr, 16000))
    unsupported = [k for k in feat_list if k not in FEAT_TYPES]
    if unsupported:
        raise NotImplementedError(
            f"feature types {unsupported} need external encoders not present; supported "
            f"here: {', '.join(repr(t) for t in FEAT_TYPES)}")
    return extractors


def main(argv=None):
    parser = argparse.ArgumentParser(description="Extract features from wav.scp (PyTorch port)")
    parser.add_argument("--wav-scp", "--scp", required=True)
    parser.add_argument("--segments", default=None)
    parser.add_argument("--dumpdir", required=True)
    parser.add_argument("--config", required=True)
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup(args.verbose)
    device = resolve_device(args.device)
    config = load_config(args.config)
    sr, hop = config["sampling_rate"], config["hop_size"]
    extractors = build_extractors(config, device)

    scp = read_scp(args.wav_scp)
    if args.segments:
        items = [(utt, scp[rec], (start, end))
                 for utt, (rec, start, end) in read_segments(args.segments).items()
                 if rec in scp]
    else:
        items = [(utt, path, None) for utt, path in scp.items()]
    seconds = dict.fromkeys(extractors, 0.0)
    audio_seconds = 0.0
    with DumpWriter(args.dumpdir, config.get("format", "hdf5")) as dump:
        for utt_id, wav_path, seg in items:
            audio, orig_sr = read_wav(wav_path)
            if audio.ndim > 1:
                audio = audio.mean(axis=1)
            if seg is not None:
                audio = audio[int(seg[0] * orig_sr): int(seg[1] * orig_sr)]
            audio = resample(audio, orig_sr, sr)
            if config.get("trim_silence", False):
                audio = trim_silence(audio, config.get("trim_threshold_in_db", 60),
                                     config.get("trim_frame_size", 2048),
                                     config.get("trim_hop_size", 512))
            gain = config.get("global_gain_scale", 1.0)
            if gain != 1.0:
                audio = audio * gain
            if np.abs(audio).max() >= 1.0:
                logging.warning("%s causes clipping; reduce global_gain_scale", utt_id)
            audio_seconds += len(audio) / sr

            start = time.perf_counter()
            mel = extractors["mel"](audio)
            seconds["mel"] += time.perf_counter() - start
            # the wave padded to len(mel) * hop, then the other types from it
            audio = np.pad(audio, (0, config["fft_size"]), mode="reflect")[: len(mel) * hop]
            dump.write(utt_id, "wave", audio.astype(np.float32))
            dump.write(utt_id, "mel", mel.astype(np.float32))
            for name, extract in extractors.items():
                if name != "mel":
                    start = time.perf_counter()
                    feat = extract(audio)
                    seconds[name] += time.perf_counter() - start
                    dump.write(utt_id, name, feat.astype(np.float32))
    logging.info("%d utterances, %.2f s of audio; seconds by type %s", len(items),
                 audio_seconds, seconds)
    return {"utterances": len(items), "audio_seconds": audio_seconds, "seconds": seconds}


if __name__ == "__main__":
    main()
