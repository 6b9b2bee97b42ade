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

Parallelism: launched by ``torchrun --nproc_per_node N -m
seq2seq_vc_torch.bin.vc_train ...`` the run is N ranks of one process group
(NCCL on the cards, ``gloo`` with ``--device cpu`` or with more ranks
than cards), laid out as the JAX driver lays out its devices
(``parallel/plan.py``): ``tensor_parallel`` ranks split each attention and
feed-forward (Megatron), ``sequence_parallel`` ranks split the conformer
stacks' time axis (ring attention), ``pipeline_parallel`` ranks split
their layers into GPipe stages over ``pipeline_microbatches`` microbatches
(default: as many as stages), and the rest of the world is data parallel,
each replica on its rows of every global batch (``train/trainer.py``).
Pipeline parallelism composes with data parallelism alone. Rank 0 writes
the config, the logs and the checkpoints, which hold the whole model in
the single-process layout (``vc_decode`` reads them as they are;
``--resume`` splits them again). ``prng_impl`` (the JAX PRNG) is accepted
and has no effect.
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
from ..parallel import get_mesh, initialize_multihost, is_coordinator
from ..parallel.plan import check_model, layout, log_layout, parallelize
from ..train import get_trainer_class
from ..train.data import ARVCCollater, DataLoader, NARVCCollater, ParallelVCMelDataset
from ..train.optim import build_optimizer, frozen_names
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
    """Log ``prng_impl``, an option of the JAX driver that has no
    counterpart in torch (the port refuses no other)."""
    if config.get("prng_impl"):
        logging.info("prng_impl %r has no effect in the port: torch's generators draw "
                     "(the JAX PRNG's draws are not reproduced)", config["prng_impl"])


def build_criterion(config: Dict[str, Any]) -> Dict[str, Any]:
    """The config's ``criterions``, and ``guided_attn`` with
    ``use_guided_attn_loss``."""
    criterion = {name: get_criterion(name, **(params or {}))
                 for name, params in config["criterions"].items()}
    if config.get("use_guided_attn_loss", False):
        criterion["guided_attn"] = GuidedMultiHeadAttentionLoss(
            **config.get("guided_attn_loss_params", {}))
    return criterion


def _freeze_mods(config: Dict[str, Any]):
    return config.get("freeze-mods") or config.get("freeze_mods")


def init_weights(model: torch.nn.Module, config: Dict[str, Any], init_checkpoint: str) -> None:
    """``--init-checkpoint`` with the config's ``init-mods``."""
    if init_checkpoint:
        mods = config.get("init-mods") or config.get("init_mods") or []
        done = init_from_checkpoint(model, init_checkpoint, mods)
        logging.info("initialized from %s: %s", init_checkpoint, done)


def build_state(model: torch.nn.Module, config: Dict[str, Any], init_checkpoint: str,
                device) -> TrainState:
    """The one place a training run's model is laid out: the initial
    weights (``--init-checkpoint`` with the config's ``init-mods``), then,
    in a process group or when a model-parallel mode is above 1 (which
    then needs a group of that size), the model laid out over the config's
    mesh (``parallel/plan.py``), then the config's optimizer (with its
    ``freeze-mods``) around what this rank holds. Raises for what the
    config's modes refuse before any group is needed."""
    sizes = layout(config)
    check_model(model, sizes)
    init_weights(model, config, init_checkpoint)
    plan = None
    if torch.distributed.is_initialized() or max(sizes.values()) > 1:
        mesh = get_mesh(model=sizes["model"], seq=sizes["seq"], pipe=sizes["pipe"])
        log_layout(sizes)
        frozen = frozen_names(model, _freeze_mods(config) or [])
        plan = parallelize(model.to(device), mesh, sizes["n_micro"], frozen)
    optimizer = build_optimizer(
        model, optimizer_type=config.get("optimizer_type", "Adam"),
        optimizer_params=config.get("optimizer_params", {}),
        scheduler=config.get("scheduler", "warmuplr"),
        scheduler_params=config.get("scheduler_params", {}), grad_norm=config.get("grad_norm"),
        gradient_accumulate_steps=config.get("gradient_accumulate_steps", 1),
        freeze_mods=_freeze_mods(config),
    )
    return TrainState(model, optimizer, plan)


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
    state = build_state(model, config, args.init_checkpoint, device)
    trainer_class = get_trainer_class(config.get("trainer_type", "ARVCTrainer"))
    trainer = trainer_class(state, build_criterion(config), config, train_loader, dev_loader,
                            device=device)
    return train(trainer, args.outdir, args.resume)


if __name__ == "__main__":
    main()
