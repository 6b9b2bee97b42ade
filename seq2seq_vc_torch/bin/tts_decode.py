"""TTS decoding driver (mirrors seq2seq_vc_tpu/bin/tts_decode.py).

    python -m seq2seq_vc_torch.bin.tts_decode --text text --checkpoint \
        exp/checkpoint-<N>steps.pt --token-list tokens.txt --outdir results \
        [--token-type phn --g2p g2p_en --cleaner tacotron] [--stats stats.npz]

Reads the training config beside the checkpoint (or ``--config``), cleans
and tokenises each line of the 2-column text, pads the token ids to a
multiple of 16 and decodes one utterance at a time with ``ChunkedARDecoder``
at the config's ``inference`` block (``maxlenratio`` 10 by default, as the
JAX driver). The prenet's dropout of utterance ``i`` draws from
``vc_decode.utterance_generator(seed, i)``. Writes each utterance's
features as ``<utt>.npy`` (listed in ``feats.scp``) and its waveform as
``wav/<utt>.wav`` through the config's vocoder (any that
``vocoder/vocoder.py`` routes), de-normalised with ``--stats``. Returns the frames, the decode seconds,
mel-frames/s and ms an utterance.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from ..core.config import load_config
from ..device import resolve_device
from ..models.ar_driver import ChunkedARDecoder
from ..text import TextCleaner, TokenIDConverter, build_tokenizer
from ..train.tts_data import read_2column_text
from ..utils.audio import write_wav
from ..utils.io import read_stats
from ..vocoder.vocoder import get_vocoder
from . import setup
from .tts_train import read_token_list
from .vc_decode import load_model, utterance_generator

TOKEN_MULTIPLE = 16  # token ids pad to this multiple, as the JAX driver pads them


def main(argv=None):
    parser = argparse.ArgumentParser(description="Decode with a trained TTS model")
    parser.add_argument("--text", required=True, help="2-column utt-id text file")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--config", default=None, help="defaults to <ckpt_dir>/config.yml")
    parser.add_argument("--token-list", required=True)
    parser.add_argument("--cleaner", default="tacotron")
    parser.add_argument("--g2p", default=None)
    parser.add_argument("--token-type", default="char")
    parser.add_argument("--stats", default=None, help="mel stats for denorm")
    parser.add_argument("--feat-type", default="mel")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup(args.verbose)
    device = resolve_device(args.device)
    config = load_config(args.config or os.path.join(os.path.dirname(args.checkpoint),
                                                     "config.yml"))
    token_list = read_token_list(args.token_list)
    cleaner = TextCleaner(args.cleaner) if args.cleaner else None
    tokenizer = build_tokenizer(token_type=args.token_type, g2p_type=args.g2p)
    converter = TokenIDConverter(token_list, unk_symbol="<unk>")

    config = dict(config, model_type=config.get("model_type", "TransformerTTS"),
                  model_params=dict(config["model_params"], idim=len(token_list)))
    model = load_model(config, args.checkpoint, device)
    stats = read_stats(args.stats, args.feat_type) if args.stats else None
    vocoder = get_vocoder(config, stats, device)
    drv = ChunkedARDecoder.from_config(model, dict({"maxlenratio": 10.0},
                                                   **(config.get("inference") or {})))
    seed = config.get("seed", 0)

    wav_dir = os.path.join(args.outdir, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    scp, total_frames, total_sec = [], 0, 0.0
    texts = read_2column_text(args.text)
    for idx, (utt, text) in enumerate(texts.items()):
        if cleaner is not None:
            text = cleaner(text)
        ids = converter.tokens2ids(tokenizer.text2tokens(text))
        xs = np.zeros((1, -(-len(ids) // TOKEN_MULTIPLE) * TOKEN_MULTIPLE), np.int64)
        xs[0, :len(ids)] = ids
        start = time.perf_counter()
        out = drv(torch.as_tensor(xs, device=device), torch.tensor([len(ids)], device=device),
                  utterance_generator(seed, idx))
        n = int(out["out_lens"][0])
        feats = out["outs"][0, :n].float().cpu().numpy()
        elapsed = time.perf_counter() - start
        total_frames += n
        total_sec += elapsed
        logging.info("%s: %d tokens -> %d frames in %.3f s", utt, len(ids), n, elapsed)
        path = os.path.join(args.outdir, f"{utt}.npy")
        np.save(path, feats)
        scp.append(f"{utt} {os.path.abspath(path)}")
        write_wav(os.path.join(wav_dir, f"{utt}.wav"), vocoder.decode(feats), vocoder.fs)
    with open(os.path.join(args.outdir, "feats.scp"), "w") as f:
        f.write("\n".join(scp) + "\n")
    rate = total_frames / max(total_sec, 1e-9)
    logging.info("decode finished: %d frames in %.3f s (avg %.1f mel-frames/sec)",
                 total_frames, total_sec, rate)
    return {"frames": total_frames, "seconds": total_sec, "frames_per_sec": rate,
            "ms_per_utt": 1e3 * total_sec / max(len(texts), 1)}


if __name__ == "__main__":
    main()
