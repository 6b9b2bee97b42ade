#!/usr/bin/env bash
# Stages 1-7 of egs/synth/vc1/run.sh on the PyTorch port (python -m
# seq2seq_vc_torch.bin.*): feature extraction (1), statistics and
# normalisation (2), AAS-VC training and decoding (3-4), the VTN teacher's
# training (5), its teacher-forced decode, which writes the durations, and
# its free-running decode (6), then FastSpeech-VC training on those
# durations and one decode of it (7). Run the JAX recipe's stage 0 first;
# it writes the synthetic corpus under the same work directory:
#
#   egs/synth/vc1/run.sh --stop_stage 0 --workdir DIR
#   scripts/run_synth_torch.sh --workdir DIR [--device cpu] [--format npy|hdf5] \
#       [--stage N --stop_stage M]
#
# --format overlays the conf's `format` (written to DIR/conf_torch): npy
# (the default; .npy features with an scp each and .npz stats, which the
# card's machine reads without h5py) or hdf5 (per-utterance .h5 files and
# stats.h5, as the JAX recipe writes them, so --stage 3 --format hdf5 also
# runs on the JAX recipe's stages 0-2). The port writes its features under
# DIR/dump and DIR/stats, checkpoint-<N>steps.pt under DIR/exp_torch,
# DIR/exp_vtn_torch and DIR/exp_fs2_torch, and decoded features (.npy,
# feats.scp), durations and wavs under DIR/results_torch,
# DIR/results_tf_torch, DIR/results_ar_torch and DIR/results_fs2_torch. A
# relative DIR is taken from egs/synth/vc1, as run.sh takes it. --device
# defaults to the card.
set -euo pipefail

stage=1
stop_stage=7
conf=conf/aas_vc.synth.yaml
workdir=${WORKDIR:-exp_synth}
device=cuda
format=npy
repo_root=$(cd "$(dirname "$0")/.." && pwd)

while [ $# -gt 0 ]; do
  case "$1" in
    --stage) stage=$2; shift 2;;
    --stop_stage) stop_stage=$2; shift 2;;
    --conf) conf=$2; shift 2;;
    --workdir) workdir=$2; shift 2;;
    --device) device=$2; shift 2;;
    --format) format=$2; shift 2;;
    *) echo "unknown option $1"; exit 1;;
  esac
done

cd "$repo_root/egs/synth/vc1"
export PYTHONPATH="$repo_root:${PYTHONPATH:-}"
# the conf with the format overlaid, and where each format keeps the
# normalised features and the stats
mkdir -p "$workdir/conf_torch"
feat_conf="$workdir/conf_torch/$(basename "$conf")"
python - "$conf" "$format" "$feat_conf" <<'PYEOF'
import sys, yaml
conf, fmt, out = sys.argv[1:]
yaml.safe_dump(dict(yaml.safe_load(open(conf)), format=fmt), open(out, "w"))
PYEOF
if [ "$format" = npy ]; then
  feats=/mel.scp; stats_ext=npz
else
  feats=; stats_ext=h5
fi
src_feats="$workdir/dump/src/norm$feats"
trg_feats="$workdir/dump/trg/norm$feats"
trg_stats="$workdir/stats/trg/stats.$stats_ext"

if [ "$stage" -le 1 ] && [ "$stop_stage" -ge 1 ]; then
  echo "=== stage 1: feature extraction (PyTorch port)"
  for spk in src trg; do
    python -m seq2seq_vc_torch.bin.preprocess \
      --wav-scp "$workdir/corpus/${spk}_wav.scp" \
      --dumpdir "$workdir/dump/${spk}/raw" --config "$feat_conf" --device "$device"
  done
fi

if [ "$stage" -le 2 ] && [ "$stop_stage" -ge 2 ]; then
  echo "=== stage 2: statistics + normalization (PyTorch port)"
  for spk in src trg; do
    python -m seq2seq_vc_torch.bin.compute_statistics \
      --rootdir "$workdir/dump/${spk}/raw" --config "$feat_conf" \
      --dumpdir "$workdir/stats/${spk}" --feat_type mel --device "$device"
    python -m seq2seq_vc_torch.bin.normalize \
      --rootdir "$workdir/dump/${spk}/raw" \
      --dumpdir "$workdir/dump/${spk}/norm" --config "$feat_conf" \
      --stats "$workdir/stats/${spk}/stats.$stats_ext" --feat_type mel --device "$device"
  done
fi

if [ "$stage" -le 3 ] && [ "$stop_stage" -ge 3 ]; then
  echo "=== stage 3: training (PyTorch port)"
  python -m seq2seq_vc_torch.bin.vc_train \
    --src-train-dumpdir "$src_feats" \
    --src-dev-dumpdir "$src_feats" \
    --trg-train-dumpdir "$trg_feats" \
    --trg-dev-dumpdir "$trg_feats" \
    --train-dp-input-dir "$src_feats" \
    --dev-dp-input-dir "$src_feats" \
    --trg-stats "$trg_stats" \
    --outdir "$workdir/exp_torch" --config "$conf" --device "$device"
fi

if [ "$stage" -le 4 ] && [ "$stop_stage" -ge 4 ]; then
  echo "=== stage 4: decoding (PyTorch port)"
  ckpt=$(ls -t "$workdir/exp_torch"/checkpoint-*steps.pt | head -1)
  python -m seq2seq_vc_torch.bin.vc_decode \
    --dumpdir "$src_feats" \
    --dp-input-dir "$src_feats" \
    --checkpoint "$ckpt" \
    --outdir "$workdir/results_torch" \
    --trg-stats "$trg_stats" --device "$device"
  echo "decoded wavs:"; ls "$workdir/results_torch/wav" | head
fi

if [ "$stage" -le 5 ] && [ "$stop_stage" -ge 5 ]; then
  echo "=== stage 5: VTN training, the teacher of FastSpeech-VC (PyTorch port)"
  python -m seq2seq_vc_torch.bin.vc_train \
    --src-train-dumpdir "$src_feats" \
    --src-dev-dumpdir "$src_feats" \
    --trg-train-dumpdir "$trg_feats" \
    --trg-dev-dumpdir "$trg_feats" \
    --trg-stats "$trg_stats" \
    --outdir "$workdir/exp_vtn_torch" --config conf/vtn.synth.yaml --device "$device"
fi

if [ "$stage" -le 6 ] && [ "$stop_stage" -ge 6 ]; then
  echo "=== stage 6: teacher-forced decode -> durations (PyTorch port)"
  ckpt=$(ls -t "$workdir/exp_vtn_torch"/checkpoint-*steps.pt | head -1)
  python -m seq2seq_vc_torch.bin.vc_decode \
    --dumpdir "$src_feats" \
    --trg-dumpdir "$trg_feats" \
    --use-teacher-forcing \
    --checkpoint "$ckpt" \
    --outdir "$workdir/results_tf_torch" \
    --trg-stats "$trg_stats" --device "$device"
  echo "durations:"; ls "$workdir/results_tf_torch/durations" | head -3
  echo "=== stage 6b: free-running AR decode (PyTorch port)"
  python -m seq2seq_vc_torch.bin.vc_decode \
    --dumpdir "$src_feats" \
    --checkpoint "$ckpt" \
    --outdir "$workdir/results_ar_torch" \
    --batch-size 4 \
    --trg-stats "$trg_stats" --device "$device"
  echo "AR decoded wavs:"; ls "$workdir/results_ar_torch/wav" | head -3
fi

if [ "$stage" -le 7 ] && [ "$stop_stage" -ge 7 ]; then
  echo "=== stage 7: FastSpeech-VC training on the teacher durations (PyTorch port)"
  python -m seq2seq_vc_torch.bin.vc_train \
    --src-train-dumpdir "$src_feats" \
    --src-dev-dumpdir "$src_feats" \
    --trg-train-dumpdir "$trg_feats" \
    --trg-dev-dumpdir "$trg_feats" \
    --train-duration-dir "$workdir/results_tf_torch/durations" \
    --dev-duration-dir "$workdir/results_tf_torch/durations" \
    --trg-stats "$trg_stats" \
    --outdir "$workdir/exp_fs2_torch" --config conf/fs2.synth.yaml --device "$device"
  echo "=== stage 7b: FastSpeech-VC decoding (PyTorch port)"
  ckpt=$(ls -t "$workdir/exp_fs2_torch"/checkpoint-*steps.pt | head -1)
  python -m seq2seq_vc_torch.bin.vc_decode \
    --dumpdir "$src_feats" \
    --checkpoint "$ckpt" \
    --outdir "$workdir/results_fs2_torch" \
    --trg-stats "$trg_stats" --device "$device"
  echo "FastSpeech-VC decoded wavs:"; ls "$workdir/results_fs2_torch/wav" | head -3
fi

echo "=== synth recipe (PyTorch port) done"
