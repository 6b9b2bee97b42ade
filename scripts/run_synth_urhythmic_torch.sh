#!/usr/bin/env bash
# Stages 0-6 of egs/synth/urhythmic/run.sh on the PyTorch port (python -m
# seq2seq_vc_torch.urhythmic.cli, then python -m seq2seq_vc_torch.bin.evaluate),
# with no JAX, sklearn or transformers:
# fixtures and resampling (0: scripts/make_synth_urhythmic_fixtures.py
# writes both speakers at 22.05 kHz, a seeded HuBERT-soft checkpoint in
# bshall naming and a segmenter fitted by the port's clustering; `resample`
# takes the speakers to 16 kHz), HuBERT-soft encoding (1), segmentation
# (2), the rhythm model (3), the vocoder fine-tune on the target speaker
# (4), conversion (5) and the objective evaluation of the converted wavs
# against the target speaker's (6).
#
#   scripts/run_synth_urhythmic_torch.sh --workdir DIR [--device cpu] \
#       [--finetune_steps 3] [--stage N --stop_stage M]
#
# A relative DIR is taken from egs/synth/urhythmic, as run.sh takes it.
# Without --device every stage runs on the card (and stops without one).
set -euo pipefail

stage=0
stop_stage=6
workdir=exp_synth_torch
finetune_steps=3
device=
repo_root=$(cd "$(dirname "$0")/.." && pwd)

while [ $# -gt 0 ]; do
  case "$1" in
    --stage) stage=$2; shift 2;;
    --stop_stage) stop_stage=$2; shift 2;;
    --workdir) workdir=$2; shift 2;;
    --device) device=$2; shift 2;;
    --finetune_steps) finetune_steps=$2; shift 2;;
    *) echo "unknown option $1"; exit 1;;
  esac
done

cd "$repo_root/egs/synth/urhythmic"
export PYTHONPATH="$repo_root:${PYTHONPATH:-}"
dev=()
if [ -n "$device" ]; then dev=(--device "$device"); fi
cli() { python3 -m seq2seq_vc_torch.urhythmic.cli "$@" "${dev[@]}"; }

if [ "$stage" -le 0 ] && [ "$stop_stage" -ge 0 ]; then
  echo "=== stage 0: synthetic corpus at 22.05 kHz + fixture checkpoints, resampled to 16 kHz"
  python3 "$repo_root/scripts/make_synth_urhythmic_fixtures.py" --workdir "$workdir" \
    --sample-rate 22050 --wav-subdir wav
  for spk in src trg; do
    cli resample --in-dir "$workdir/$spk/wav" --out-dir "$workdir/$spk/wav16k"
  done
fi

if [ "$stage" -le 1 ] && [ "$stop_stage" -ge 1 ]; then
  echo "=== stage 1: HuBERT-soft encoding"
  for spk in src trg; do
    cli encode --in-dir "$workdir/$spk/wav16k" --out-dir "$workdir/$spk/enc" \
      --hubert-checkpoint "$workdir/downloads/hubert_soft_random.pt"
  done
fi

if [ "$stage" -le 2 ] && [ "$stop_stage" -ge 2 ]; then
  echo "=== stage 2: segmentation"
  for spk in src trg; do
    cli segment --logprob-dir "$workdir/$spk/enc/logprobs" \
      --out-dir "$workdir/$spk/segments" \
      --segmenter-checkpoint "$workdir/downloads/segmenter.pkl"
  done
fi

if [ "$stage" -le 3 ] && [ "$stop_stage" -ge 3 ]; then
  echo "=== stage 3: rhythm model"
  cli train-rhythm-model --source-segments "$workdir/src/segments" \
    --target-segments "$workdir/trg/segments" --out-path "$workdir/rhythm_src_trg.pkl"
fi

if [ "$stage" -le 4 ] && [ "$stop_stage" -ge 4 ]; then
  echo "=== stage 4: vocoder fine-tune on the target speaker"
  cli fine-tune-vocoder --wav-dir "$workdir/trg/wav16k" --unit-dir "$workdir/trg/enc/soft" \
    --checkpoint-dir "$workdir/voc_trg" --steps "$finetune_steps"
fi

if [ "$stage" -le 5 ] && [ "$stop_stage" -ge 5 ]; then
  echo "=== stage 5: conversion"
  ckpt=$(ls -dt "$workdir/voc_trg"/model-*.ckpt | head -1)
  cli convert --in-dir "$workdir/src/enc" --out-dir "$workdir/converted_src_trg" \
    --segmenter-checkpoint "$workdir/downloads/segmenter.pkl" \
    --rhythm-model-checkpoint "$workdir/rhythm_src_trg.pkl" --vocoder-checkpoint "$ckpt"
fi

if [ "$stage" -le 6 ] && [ "$stop_stage" -ge 6 ]; then
  echo "=== stage 6: objective evaluation"
  python3 -m seq2seq_vc_torch.bin.evaluate \
    --wavdir "$workdir/converted_src_trg" \
    --gt-wavdir "$workdir/trg/wav16k" \
    --f0min 60 --f0max 400 \
    --out "$workdir/eval/results.txt" "${dev[@]}"
fi

echo "=== synth urhythmic recipe done on the port"
