"""VC training driver (mirrors seq2seq_vc_tpu/bin/vc_train.py:98-299).

    python -m seq2seq_vc_torch.bin.vc_train --config conf.yaml --outdir exp \
        --src-train-dumpdir ... --src-dev-dumpdir ... \
        --trg-train-dumpdir ... --trg-dev-dumpdir ... [--resume ckpt.pt] \
        [--train-duration-dir DIR --dev-duration-dir DIR]  # FastSpeech-VC

The YAML config, the CLI arguments merged over it and the
``--additional-config`` overlay give the effective config, dumped to
``<outdir>/config.yml``. Collater, model, criteria, optimizer, scheduler and
trainer are picked by their config names; ``--resume`` restores a
checkpoint and the run continues where it stopped; a final
``checkpoint-<N>steps.pt`` is written in ``finally``. The model's weights
come from torch's generator seeded with the config's ``seed``. The
duration directories hold FastSpeech-VC's teacher durations, one
``<utt>.txt`` each, as ``vc_decode --use-teacher-forcing`` writes them.

``--init-checkpoint`` starts the model from a port checkpoint's weights:
with ``init-mods`` only those modules (``core/checkpoint.py``: JAX module
names, so ``decoder`` leaves the prenet, which is ``dprenet``), else all.
``freeze-mods`` freezes modules by the same names (``train/optim.py``).
With ``use_guided_attn_loss`` the criteria gain ``guided_attn``, a
``GuidedMultiHeadAttentionLoss`` of ``guided_attn_loss_params``. This is
the VTN's TTS pretraining (``egs/ljspeech/tts1/run.sh`` stage 6: the
Transformer-TTS conf, ``--additional-config tts_aept.v1.yaml`` and the TTS
checkpoint).

Data parallelism: launched by ``torchrun --nproc_per_node N -m
seq2seq_vc_torch.bin.vc_train ...`` the run is N ranks of one process group
(NCCL on the cards, ``gloo`` with ``--device cpu``), each on its rows of
every global batch (``train/trainer.py``); rank 0 writes the config, the
logs and the checkpoints. ``prng_impl`` (the JAX PRNG) is accepted and has
no effect. Refused, with the ROADMAP.md item (queue 1) that lifts the
refusal: ``tensor_parallel``, ``sequence_parallel`` and ``pipeline_parallel``
above 1 (item 5's last part).
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Any, Dict

import torch

import seq2seq_vc_torch

from ..core.checkpoint import init_from_checkpoint
from ..core.config import dump_config, load_config, merge_args
from ..losses import GuidedMultiHeadAttentionLoss, get_criterion
from ..models import get_model_class
from ..device import resolve_device
from ..parallel import initialize_multihost, is_coordinator
from ..train import get_trainer_class
from ..train.data import ARVCCollater, DataLoader, NARVCCollater, ParallelVCMelDataset
from ..train.optim import build_optimizer
from ..train.state import TrainState
from . import setup


def build_collater(config: Dict[str, Any]):
    name = config.get("collater_type", "ARVCCollater")
    mp = config.get("model_params", {})
    pad = config.get("pad_multiple", 32)
    if name == "ARVCCollater":
        return ARVCCollater(pad, mp.get("decoder_reduction_factor", 1))
    if name == "NARVCCollater":
        return NARVCCollater(pad, mp.get("encoder_reduction_factor", 1),
                             mp.get("post_encoder_reduction_factor", 1),
                             mp.get("decoder_reduction_factor", 1))
    raise ValueError(f"unknown collater_type: {name}")


def refuse_unported(config: Dict[str, Any]) -> None:
    """Raise for an option of the JAX driver that the port does not have;
    log ``prng_impl``, which has no counterpart in torch."""
    if config.get("prng_impl"):
        logging.info("prng_impl %r has no effect in the port: torch's generators draw "
                     "(the JAX PRNG's draws are not reproduced)", config["prng_impl"])
    for key in ("tensor_parallel", "sequence_parallel", "pipeline_parallel"):
        if int(config.get(key) or 1) > 1:
            raise NotImplementedError(
                f"{key} is not ported yet: ROADMAP.md queue 1 item 5, its last part "
                "(parallel/tp.py, pp.py and ring_attention.py); data parallelism runs "
                "under torchrun")


def build_criterion(config: Dict[str, Any]) -> Dict[str, Any]:
    """The config's ``criterions``, and ``guided_attn`` with
    ``use_guided_attn_loss``."""
    criterion = {name: get_criterion(name, **(params or {}))
                 for name, params in config["criterions"].items()}
    if config.get("use_guided_attn_loss", False):
        criterion["guided_attn"] = GuidedMultiHeadAttentionLoss(
            **config.get("guided_attn_loss_params", {}))
    return criterion


def prepare_model(model: torch.nn.Module, config: Dict[str, Any], init_checkpoint: str):
    """``--init-checkpoint`` with the config's ``init-mods``, then the
    optimizer of the config (with its ``freeze-mods``) around ``model``."""
    if init_checkpoint:
        mods = config.get("init-mods") or config.get("init_mods") or []
        done = init_from_checkpoint(model, init_checkpoint, mods)
        logging.info("initialized from %s: %s", init_checkpoint, done)
    return build_optimizer(
        model, optimizer_type=config.get("optimizer_type", "Adam"),
        optimizer_params=config.get("optimizer_params", {}),
        scheduler=config.get("scheduler", "warmuplr"),
        scheduler_params=config.get("scheduler_params", {}), grad_norm=config.get("grad_norm"),
        gradient_accumulate_steps=config.get("gradient_accumulate_steps", 1),
        freeze_mods=config.get("freeze-mods") or config.get("freeze_mods"),
    )


def train(trainer, outdir: str, resume: str):
    """``--resume``, the run, and the final checkpoint in ``finally``."""
    if resume:
        trainer.load_checkpoint(resume)
        logging.info("resumed from %s (steps=%d)", resume, trainer.steps)
    try:
        trainer.run()
    finally:
        trainer.save_checkpoint(os.path.join(outdir, f"checkpoint-{trainer.steps}steps.pt"))
        logging.info("saved final checkpoint @ %d steps", trainer.steps)
    return trainer


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train a VC model (PyTorch port)")
    parser.add_argument("--src-train-dumpdir", required=True)
    parser.add_argument("--src-dev-dumpdir", required=True)
    parser.add_argument("--trg-train-dumpdir", required=True)
    parser.add_argument("--trg-dev-dumpdir", required=True)
    parser.add_argument("--trg-stats", default=None)
    parser.add_argument("--src-feat-type", default="mel")
    parser.add_argument("--trg-feat-type", default="mel")
    parser.add_argument("--train-dp-input-dir", default=None)
    parser.add_argument("--dev-dp-input-dir", default=None)
    parser.add_argument("--train-duration-dir", default=None)
    parser.add_argument("--dev-duration-dir", default=None)
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

    collater = build_collater(config)
    datasets = [
        ParallelVCMelDataset(src, trg, dp_feats=dp, feat_key=args.src_feat_type,
                             allow_cache=config.get("allow_cache", False), durations_dir=dur)
        for src, trg, dp, dur in ((args.src_train_dumpdir, args.trg_train_dumpdir,
                                   args.train_dp_input_dir, args.train_duration_dir),
                                  (args.src_dev_dumpdir, args.trg_dev_dumpdir,
                                   args.dev_dp_input_dir, args.dev_duration_dir))
    ]
    seed = config.get("seed", 0)
    train_loader = DataLoader(datasets[0], collater, config["batch_size"], shuffle=True, seed=seed)
    dev_loader = DataLoader(datasets[1], collater, config["batch_size"], shuffle=False)
    logging.info("train utts = %d, dev utts = %d", *map(len, datasets))

    torch.manual_seed(seed)
    model = get_model_class(config["model_type"])(**config["model_params"])
    logging.info("model parameters: %.2fM", sum(p.numel() for p in model.parameters()) / 1e6)
    optimizer = prepare_model(model, config, args.init_checkpoint)
    trainer_class = get_trainer_class(config.get("trainer_type", "ARVCTrainer"))
    trainer = trainer_class(TrainState(model, optimizer), build_criterion(config), config,
                            train_loader, dev_loader, device=device)
    return train(trainer, args.outdir, args.resume)


if __name__ == "__main__":
    main()
