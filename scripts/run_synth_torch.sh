#!/usr/bin/env bash
# Stages 3-4 of egs/synth/vc1/run.sh (training, then decoding) on the
# PyTorch port (python -m seq2seq_vc_torch.bin.*). Run the JAX recipe's
# stages 0-2 first; they leave the normalised features and the stats
# under the same work directory:
#
#   egs/synth/vc1/run.sh --stop_stage 2 --workdir DIR
#   scripts/run_synth_torch.sh --workdir DIR [--device cpu]
#
# The port writes checkpoint-<N>steps.pt under DIR/exp_torch and the
# decoded features (.npy, feats.scp), durations and wavs under
# DIR/results_torch. A relative DIR is taken from egs/synth/vc1, as
# run.sh takes it. --device defaults to the card.
set -euo pipefail

stage=3
stop_stage=4
conf=conf/aas_vc.synth.yaml
workdir=${WORKDIR:-exp_synth}
device=cuda
repo_root=$(cd "$(dirname "$0")/.." && pwd)

while [ $# -gt 0 ]; do
  case "$1" in
    --stage) stage=$2; shift 2;;
    --stop_stage) stop_stage=$2; shift 2;;
    --conf) conf=$2; shift 2;;
    --workdir) workdir=$2; shift 2;;
    --device) device=$2; shift 2;;
    *) echo "unknown option $1"; exit 1;;
  esac
done

cd "$repo_root/egs/synth/vc1"
export PYTHONPATH="$repo_root:${PYTHONPATH:-}"

if [ "$stage" -le 3 ] && [ "$stop_stage" -ge 3 ]; then
  echo "=== stage 3: training (PyTorch port)"
  python -m seq2seq_vc_torch.bin.vc_train \
    --src-train-dumpdir "$workdir/dump/src/norm" \
    --src-dev-dumpdir "$workdir/dump/src/norm" \
    --trg-train-dumpdir "$workdir/dump/trg/norm" \
    --trg-dev-dumpdir "$workdir/dump/trg/norm" \
    --train-dp-input-dir "$workdir/dump/src/norm" \
    --dev-dp-input-dir "$workdir/dump/src/norm" \
    --trg-stats "$workdir/stats/trg/stats.h5" \
    --outdir "$workdir/exp_torch" --config "$conf" --device "$device"
fi

if [ "$stage" -le 4 ] && [ "$stop_stage" -ge 4 ]; then
  echo "=== stage 4: decoding (PyTorch port)"
  ckpt=$(ls -t "$workdir/exp_torch"/checkpoint-*steps.pt | head -1)
  python -m seq2seq_vc_torch.bin.vc_decode \
    --dumpdir "$workdir/dump/src/norm" \
    --dp-input-dir "$workdir/dump/src/norm" \
    --checkpoint "$ckpt" \
    --outdir "$workdir/results_torch" \
    --trg-stats "$workdir/stats/trg/stats.h5" --device "$device"
  echo "decoded wavs:"; ls "$workdir/results_torch/wav" | head
fi
