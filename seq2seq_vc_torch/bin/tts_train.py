"""TTS training driver (mirrors seq2seq_vc_tpu/bin/tts_train.py).

    python -m seq2seq_vc_torch.bin.tts_train --config transformer_tts.v1.yaml \
        --outdir exp --train-dumpdir feats.scp --dev-dumpdir feats.scp \
        --train-text text --dev-text text --token-list tokens.txt \
        [--token-type phn --g2p g2p_en --cleaner tacotron] [--resume ckpt.pt]

``vc_train``'s skeleton on text: a ``TTSDataset`` (the 2-column text, the
token list of ``tokenize_text`` and the target mels) with the
``ARTTSCollater``, the model of ``model_type`` (``TransformerTTS``) with
``idim`` set to the vocabulary size, and the ``ARTTSTrainer`` by default.
``--init-checkpoint``, ``init-mods``, ``freeze-mods``, the guided-attention
criterion, ``--resume`` and the final ``checkpoint-<N>steps.pt`` are
``vc_train``'s, and so are data and tensor parallelism under ``torchrun``
(``tensor_parallel``: the encoder's and decoder's attention, the source
attention included, and feed-forwards split over ranks; the model has no
conformer stack for the sequence and pipeline modes, which raise) and
``prng_impl``. ``--stats`` is accepted and not read, as in the JAX driver
(training reads normalised features).
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

import seq2seq_vc_torch

from ..core.config import dump_config, load_config, merge_args
from ..device import resolve_device
from ..models import get_model_class
from ..parallel import initialize_multihost, is_coordinator
from ..train import get_trainer_class
from ..train.data import DataLoader
from ..train.tts_data import ARTTSCollater, TTSDataset
from . import setup
from .vc_train import build_criterion, build_state, refuse_unported, train


def read_token_list(path: str):
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train a TTS model (PyTorch port)")
    parser.add_argument("--train-dumpdir", required=True)
    parser.add_argument("--dev-dumpdir", required=True)
    parser.add_argument("--train-text", required=True)
    parser.add_argument("--dev-text", required=True)
    parser.add_argument("--token-list", required=True)
    parser.add_argument("--non-linguistic-symbols", default=None)
    parser.add_argument("--cleaner", default="tacotron")
    parser.add_argument("--g2p", default=None)
    parser.add_argument("--token-type", default="char")
    parser.add_argument("--feat-type", default="mel")
    parser.add_argument("--stats", default=None)
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--config", required=True)
    parser.add_argument("--additional-config", default=None)
    parser.add_argument("--init-checkpoint", default="")
    parser.add_argument("--resume", default="")
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup(args.verbose)
    device = initialize_multihost(resolve_device(args.device))

    config = merge_args(load_config(args.config), args, args.additional_config)
    refuse_unported(config)
    os.makedirs(args.outdir, exist_ok=True)
    if is_coordinator():
        dump_config(config, args.outdir, seq2seq_vc_torch.__version__)

    token_list = read_token_list(args.token_list)
    logging.info("vocabulary size = %d", len(token_list))
    mp = config.get("model_params", {})
    collater = ARTTSCollater(config.get("pad_multiple", 32), mp.get("decoder_reduction_factor", 1))
    ds_kwargs = dict(non_linguistic_symbols=args.non_linguistic_symbols, cleaner=args.cleaner,
                     g2p=args.g2p, token_list=token_list, token_type=args.token_type,
                     feat_key=args.feat_type, allow_cache=config.get("allow_cache", False))
    train_ds = TTSDataset(args.train_dumpdir, args.train_text, **ds_kwargs)
    dev_ds = TTSDataset(args.dev_dumpdir, args.dev_text, **ds_kwargs)
    seed = config.get("seed", 0)
    train_loader = DataLoader(train_ds, collater, config["batch_size"], shuffle=True, seed=seed)
    dev_loader = DataLoader(dev_ds, collater, config["batch_size"], shuffle=False)
    logging.info("train utts = %d, dev utts = %d", len(train_ds), len(dev_ds))

    torch.manual_seed(seed)
    model = get_model_class(config.get("model_type", "TransformerTTS"))(
        **dict(mp, idim=len(token_list)))
    logging.info("model parameters: %.2fM", sum(p.numel() for p in model.parameters()) / 1e6)
    state = build_state(model, config, args.init_checkpoint, device)
    trainer_class = get_trainer_class(config.get("trainer_type", "ARTTSTrainer"))
    trainer = trainer_class(state, build_criterion(config), config, train_loader, dev_loader,
                            device=device)
    return train(trainer, args.outdir, args.resume)


if __name__ == "__main__":
    main()
