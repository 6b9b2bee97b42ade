#!/usr/bin/env bash
# Stages 3-7 of egs/synth/vc1/run.sh on the PyTorch port (python -m
# seq2seq_vc_torch.bin.*): AAS-VC training and decoding (3-4), the VTN
# teacher's training (5), its teacher-forced decode, which writes the
# durations, and its free-running decode (6), then FastSpeech-VC training
# on those durations and one decode of it (7). Run the JAX recipe's stages
# 0-2 first; they leave the normalised features and the stats under the
# same work directory:
#
#   egs/synth/vc1/run.sh --stop_stage 2 --workdir DIR
#   scripts/run_synth_torch.sh --workdir DIR [--device cpu] [--stage N --stop_stage M]
#
# The port writes checkpoint-<N>steps.pt under DIR/exp_torch,
# DIR/exp_vtn_torch and DIR/exp_fs2_torch, and decoded features (.npy,
# feats.scp), durations and wavs under DIR/results_torch,
# DIR/results_tf_torch, DIR/results_ar_torch and DIR/results_fs2_torch. A
# relative DIR is taken from egs/synth/vc1, as run.sh takes it. --device
# defaults to the card.
set -euo pipefail

stage=3
stop_stage=7
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

if [ "$stage" -le 5 ] && [ "$stop_stage" -ge 5 ]; then
  echo "=== stage 5: VTN training, the teacher of FastSpeech-VC (PyTorch port)"
  python -m seq2seq_vc_torch.bin.vc_train \
    --src-train-dumpdir "$workdir/dump/src/norm" \
    --src-dev-dumpdir "$workdir/dump/src/norm" \
    --trg-train-dumpdir "$workdir/dump/trg/norm" \
    --trg-dev-dumpdir "$workdir/dump/trg/norm" \
    --trg-stats "$workdir/stats/trg/stats.h5" \
    --outdir "$workdir/exp_vtn_torch" --config conf/vtn.synth.yaml --device "$device"
fi

if [ "$stage" -le 6 ] && [ "$stop_stage" -ge 6 ]; then
  echo "=== stage 6: teacher-forced decode -> durations (PyTorch port)"
  ckpt=$(ls -t "$workdir/exp_vtn_torch"/checkpoint-*steps.pt | head -1)
  python -m seq2seq_vc_torch.bin.vc_decode \
    --dumpdir "$workdir/dump/src/norm" \
    --trg-dumpdir "$workdir/dump/trg/norm" \
    --use-teacher-forcing \
    --checkpoint "$ckpt" \
    --outdir "$workdir/results_tf_torch" \
    --trg-stats "$workdir/stats/trg/stats.h5" --device "$device"
  echo "durations:"; ls "$workdir/results_tf_torch/durations" | head -3
  echo "=== stage 6b: free-running AR decode (PyTorch port)"
  python -m seq2seq_vc_torch.bin.vc_decode \
    --dumpdir "$workdir/dump/src/norm" \
    --checkpoint "$ckpt" \
    --outdir "$workdir/results_ar_torch" \
    --batch-size 4 \
    --trg-stats "$workdir/stats/trg/stats.h5" --device "$device"
  echo "AR decoded wavs:"; ls "$workdir/results_ar_torch/wav" | head -3
fi

if [ "$stage" -le 7 ] && [ "$stop_stage" -ge 7 ]; then
  echo "=== stage 7: FastSpeech-VC training on the teacher durations (PyTorch port)"
  python -m seq2seq_vc_torch.bin.vc_train \
    --src-train-dumpdir "$workdir/dump/src/norm" \
    --src-dev-dumpdir "$workdir/dump/src/norm" \
    --trg-train-dumpdir "$workdir/dump/trg/norm" \
    --trg-dev-dumpdir "$workdir/dump/trg/norm" \
    --train-duration-dir "$workdir/results_tf_torch/durations" \
    --dev-duration-dir "$workdir/results_tf_torch/durations" \
    --trg-stats "$workdir/stats/trg/stats.h5" \
    --outdir "$workdir/exp_fs2_torch" --config conf/fs2.synth.yaml --device "$device"
  echo "=== stage 7b: FastSpeech-VC decoding (PyTorch port)"
  ckpt=$(ls -t "$workdir/exp_fs2_torch"/checkpoint-*steps.pt | head -1)
  python -m seq2seq_vc_torch.bin.vc_decode \
    --dumpdir "$workdir/dump/src/norm" \
    --checkpoint "$ckpt" \
    --outdir "$workdir/results_fs2_torch" \
    --trg-stats "$workdir/stats/trg/stats.h5" --device "$device"
  echo "FastSpeech-VC decoded wavs:"; ls "$workdir/results_fs2_torch/wav" | head -3
fi

echo "=== synth recipe (PyTorch port) done"
