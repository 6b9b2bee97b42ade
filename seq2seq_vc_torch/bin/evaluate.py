"""Objective evaluation driver (mirrors seq2seq_vc_tpu/bin/evaluate.py).

    python -m seq2seq_vc_torch.bin.evaluate --wavdir exp/results/wav \\
        --gt-wavdir data/trg/wav [--f0-yaml conf/f0.yaml --spk slt] \\
        [--transcription text --asr-model /path/to/wav2vec2-dir] [--out results.txt]

MCD, F0RMSE, F0CORR and DDUR between converted and ground-truth wavs
(matched by utterance id) on the host, over ``--n-jobs`` processes (spawned,
so that a parent that holds a CUDA context forks none), and the mean CER
and WER of the converted wavs where a transcription and a local wav2vec2
directory are given (``evaluate/asr.py``: the port's own wav2vec2 for CTC
on ``--device``, default the card). ``--gt-ceiling`` gives the ASR's CER
and WER on the ground-truth wavs themselves (the intelligibility ceiling a
conversion is compared against) and skips the signal metrics. ``--out``
writes one ``<utt> <values>`` line an utterance, as the JAX driver writes
it. ``main`` returns the means.
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing as mp
import os
from typing import Dict, List

import numpy as np

from ..device import resolve_device
from ..evaluate import calculate_mcd_f0, character_error_rate, word_error_rate
from ..utils.audio import read_wav
from ..utils.io import find_files, get_basename
from . import setup

METRICS = ("MCD", "F0RMSE", "F0CORR", "DDUR")


def _evaluate_one(args):
    cvt_path, gt_path, fs, f0min, f0max = args
    cvt, fs1 = read_wav(cvt_path)
    gt, fs2 = read_wav(gt_path)
    assert fs1 == fs2 == fs, f"sampling rate mismatch for {cvt_path}"
    res = calculate_mcd_f0(gt, cvt, fs, f0min, f0max)
    res["utt_id"] = get_basename(cvt_path)
    return res


def _write(path: str, lines: List[str]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _asr_rates(asr, wavs, texts):
    """{utt: (CER, WER)} of the wavs that have a transcription."""
    out = {}
    for p in wavs:
        utt = get_basename(p)
        if utt in texts:
            audio, sr = read_wav(p)
            hyp = asr.transcribe(audio, sr)
            out[utt] = (character_error_rate(hyp, texts[utt]), word_error_rate(hyp, texts[utt]))
    return out


def main(argv=None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(description="Objective evaluation (MCD/F0/DDUR, CER/WER)")
    parser.add_argument("--wavdir", required=True, help="converted wav dir")
    parser.add_argument("--gt-wavdir", required=True, help="ground truth wav dir")
    parser.add_argument("--f0min", type=float, default=100)
    parser.add_argument("--f0max", type=float, default=400)
    parser.add_argument("--f0-yaml", default=None,
                        help="per-speaker F0 range yaml (conf/f0.yaml); overrides "
                             "--f0min/--f0max")
    parser.add_argument("--spk", default=None,
                        help="speaker key into --f0-yaml (omit for a flat single-speaker "
                             "f0.yaml)")
    parser.add_argument("--fs", type=int, default=16000)
    parser.add_argument("--n-jobs", type=int, default=8)
    parser.add_argument("--transcription", default=None, help="2-col utt text file")
    parser.add_argument("--asr-model", default=None, help="local wav2vec2 directory")
    parser.add_argument("--out", default=None, help="optional results file")
    parser.add_argument("--gt-ceiling", action="store_true",
                        help="ASR CER/WER of the ground-truth wavs themselves (requires "
                             "--transcription and --asr-model; skips MCD/F0)")
    parser.add_argument("--device", default=None, help="the ASR's torch device "
                                                       "(default: the card)")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup(args.verbose)
    device = resolve_device(args.device)
    if args.gt_ceiling and not (args.transcription and args.asr_model):
        parser.error("--gt-ceiling requires --transcription and --asr-model")
    asr = texts = None
    if args.transcription and args.asr_model:
        from ..evaluate.asr import ASRTranscriber
        from ..train.tts_data import read_2column_text

        texts = read_2column_text(args.transcription)
        asr = ASRTranscriber(args.asr_model, device=device)

    if args.gt_ceiling:
        rates = _asr_rates(asr, sorted(find_files(args.gt_wavdir, "*.wav")), texts)
        lines = []
        for utt, (cer, wer) in rates.items():
            lines.append(f"{utt} {cer:.4f} {wer:.4f}")
            logging.info("%s: CER %.1f%% WER %.1f%%", utt, 100 * cer, 100 * wer)
        means = {"CER": float(np.mean([r[0] for r in rates.values()])),
                 "WER": float(np.mean([r[1] for r in rates.values()]))}
        logging.info("GT ceiling mean CER/WER over %d utts: %.1f%% / %.1f%%", len(rates),
                     100 * means["CER"], 100 * means["WER"])
        if args.out:
            _write(args.out, lines)
        return means

    if args.f0_yaml:
        import yaml

        with open(args.f0_yaml) as f:
            ranges = yaml.safe_load(f)
        if args.spk is not None:
            ranges = ranges[args.spk]
        args.f0min, args.f0max = float(ranges["f0min"]), float(ranges["f0max"])
        logging.info("F0 search range from %s: [%g, %g] Hz", args.f0_yaml, args.f0min,
                     args.f0max)
    cvt_wavs = sorted(find_files(args.wavdir, "*.wav"))
    gt_map = {get_basename(p): p for p in find_files(args.gt_wavdir, "*.wav")}
    pairs = [(p, gt_map[get_basename(p)], args.fs, args.f0min, args.f0max)
             for p in cvt_wavs if get_basename(p) in gt_map]
    logging.info("evaluating %d utterance pairs", len(pairs))
    if args.n_jobs > 1:
        with mp.get_context("spawn").Pool(args.n_jobs) as pool:
            results = pool.map(_evaluate_one, pairs)
    else:
        results = [_evaluate_one(p) for p in pairs]

    lines = []
    for r in sorted(results, key=lambda r: r["utt_id"]):
        vals = " ".join(f"{r[m]:.4f}" for m in METRICS)
        lines.append(f"{r['utt_id']} {vals}")
        logging.info("%s: %s", r["utt_id"], vals)
    means = {m: float(np.nanmean([r[m] for r in results])) for m in METRICS}
    logging.info("Mean MCD, f0RMSE, f0CORR, DDUR: %.2f dB, %.2f Hz, %.3f, %.3f s",
                 means["MCD"], means["F0RMSE"], means["F0CORR"], means["DDUR"])
    if asr is not None:
        rates = _asr_rates(asr, cvt_wavs, texts)
        means["CER"] = float(np.mean([r[0] for r in rates.values()]))
        means["WER"] = float(np.mean([r[1] for r in rates.values()]))
        logging.info("Mean CER/WER: %.1f%% / %.1f%%", 100 * means["CER"], 100 * means["WER"])
    if args.out:
        _write(args.out, lines)
    return means


if __name__ == "__main__":
    main()
