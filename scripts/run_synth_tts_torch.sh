#!/usr/bin/env bash
# egs/synth/tts1/run.sh's tokenize, tts_train and tts_decode stages on the
# PyTorch port (python -m seq2seq_vc_torch.bin.*), then the VTN's TTS
# pretraining on the same corpus: the AEPT stage of egs/ljspeech/tts1/run.sh
# (vc_train with the TTS conf, tts_aept.v1.yaml and the TTS checkpoint) and
# the fine-tune of egs/arctic/vc1/conf/vtn.tts_pt.v1.yaml from the AEPT
# checkpoint. Run the JAX recipe's stage 0 first; it writes the corpus and
# its transcripts under the same work directory:
#
#   egs/synth/tts1/run.sh --stop_stage 0 --workdir DIR
#   scripts/run_synth_tts_torch.sh --workdir DIR [--device cpu] [--format npy|hdf5] \
#       [--stage N --stop_stage M]
#
# Stages: 1 tokenize (DIR/tokens_torch.txt), 2 preprocess, statistics and
# normalisation of the corpus's source speaker (DIR/dump, DIR/stats; the
# conf's `format` overlaid by --format, written to DIR/conf_torch: npy, the
# default, which the card's machine reads without h5py, or hdf5 as the JAX
# recipe writes it), 3 tts_train (DIR/exp_torch), 4
# tts_decode of three sentences (DIR/results_torch: .npy, feats.scp, wavs),
# 5 AEPT (DIR/exp_aept_torch), 6 fine-tune (DIR/exp_tune_torch). The AEPT
# and fine-tune overlays are the shipped ones with the synth conf's model
# widths and step counts, written to DIR/conf_torch. A relative DIR is taken
# from egs/synth/tts1, as run.sh takes it. --device defaults to the card.
set -euo pipefail

stage=1
stop_stage=6
conf=conf/tts.synth.yaml
workdir=${WORKDIR:-exp_synth_tts}
device=cuda
format=npy
token_type=phn
g2p=g2p_en
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

cd "$repo_root/egs/synth/tts1"
export PYTHONPATH="$repo_root:${PYTHONPATH:-}"
mkdir -p "$workdir/conf_torch"
feat_conf="$workdir/conf_torch/$(basename "$conf")"
python - "$conf" "$format" "$feat_conf" <<'PYEOF'
import sys, yaml
conf, fmt, out = sys.argv[1:]
yaml.safe_dump(dict(yaml.safe_load(open(conf)), format=fmt), open(out, "w"))
PYEOF
if [ "$format" = npy ]; then
  feats="$workdir/dump/norm/mel.scp"; stats="$workdir/stats/stats.npz"
else
  feats="$workdir/dump/norm"; stats="$workdir/stats/stats.h5"
fi
text=("--token-type" "$token_type" "--g2p" "$g2p" "--cleaner" "tacotron")

if [ "$stage" -le 1 ] && [ "$stop_stage" -ge 1 ]; then
  echo "=== stage 1: tokenize (PyTorch port)"
  python -m seq2seq_vc_torch.bin.tokenize_text \
    --input "$workdir/corpus/text" --output "$workdir/tokens_torch.txt" \
    --token_type "$token_type" --g2p "$g2p" --cleaner tacotron --field 2-
fi

if [ "$stage" -le 2 ] && [ "$stop_stage" -ge 2 ]; then
  echo "=== stage 2: features + stats + normalize, the src speaker as the TTS voice (PyTorch port)"
  python -m seq2seq_vc_torch.bin.preprocess \
    --wav-scp "$workdir/corpus/src_wav.scp" \
    --dumpdir "$workdir/dump/raw" --config "$feat_conf" --device "$device"
  python -m seq2seq_vc_torch.bin.compute_statistics \
    --rootdir "$workdir/dump/raw" --config "$feat_conf" --dumpdir "$workdir/stats" \
    --device "$device"
  python -m seq2seq_vc_torch.bin.normalize \
    --rootdir "$workdir/dump/raw" --dumpdir "$workdir/dump/norm" --config "$feat_conf" \
    --stats "$stats" --device "$device"
fi

if [ "$stage" -le 3 ] && [ "$stop_stage" -ge 3 ]; then
  echo "=== stage 3: TTS training (PyTorch port)"
  python -m seq2seq_vc_torch.bin.tts_train \
    --train-dumpdir "$feats" --dev-dumpdir "$feats" \
    --train-text "$workdir/corpus/text" --dev-text "$workdir/corpus/text" \
    --token-list "$workdir/tokens_torch.txt" "${text[@]}" \
    --outdir "$workdir/exp_torch" --config "$conf" --device "$device"
fi

if [ "$stage" -le 4 ] && [ "$stop_stage" -ge 4 ]; then
  echo "=== stage 4: TTS decoding (PyTorch port)"
  ckpt=$(ls -t "$workdir/exp_torch"/checkpoint-*steps.pt | head -1)
  head -3 "$workdir/corpus/text" > "$workdir/decode_text"
  python -m seq2seq_vc_torch.bin.tts_decode \
    --text "$workdir/decode_text" --checkpoint "$ckpt" \
    --token-list "$workdir/tokens_torch.txt" "${text[@]}" \
    --stats "$stats" \
    --outdir "$workdir/results_torch" --device "$device"
  ls "$workdir/results_torch/wav"
fi

if [ "$stage" -le 6 ] && [ "$stop_stage" -ge 5 ]; then
  # the shipped overlays at the synth conf's widths and steps
  mkdir -p "$workdir/conf_torch"
  python - "$repo_root" "$conf" "$workdir/conf_torch" <<'PYEOF'
import sys, yaml
repo, conf, out = sys.argv[1:]
synth = yaml.safe_load(open(conf))
keep = {k: synth[k] for k in ("batch_size", "pad_multiple", "train_max_steps",
                              "save_interval_steps", "eval_interval_steps",
                              "log_interval_steps")}
widths = ("dprenet_units", "adim", "aheads", "elayers", "eunits", "dlayers", "dunits",
          "postnet_layers", "postnet_chans")
aept = yaml.safe_load(open(f"{repo}/egs/ljspeech/tts1/conf/tts_aept.v1.yaml"))
aept["model_params"].update({k: synth["model_params"][k] for k in widths})
aept.update(keep)
yaml.safe_dump(aept, open(f"{out}/tts_aept.synth.yaml", "w"))
tune = yaml.safe_load(open(f"{repo}/egs/arctic/vc1/conf/vtn.tts_pt.v1.yaml"))
tune.update(keep)
yaml.safe_dump(tune, open(f"{out}/vtn.tts_pt.synth.yaml", "w"))
PYEOF
fi

if [ "$stage" -le 5 ] && [ "$stop_stage" -ge 5 ]; then
  echo "=== stage 5: TTS-AEPT, mel encoder, decoder from the TTS and frozen (PyTorch port)"
  ckpt=$(ls -t "$workdir/exp_torch"/checkpoint-*steps.pt | head -1)
  python -m seq2seq_vc_torch.bin.vc_train \
    --src-train-dumpdir "$feats" --src-dev-dumpdir "$feats" \
    --trg-train-dumpdir "$feats" --trg-dev-dumpdir "$feats" \
    --init-checkpoint "$ckpt" \
    --outdir "$workdir/exp_aept_torch" --config "$conf" \
    --additional-config "$workdir/conf_torch/tts_aept.synth.yaml" --device "$device"
fi

if [ "$stage" -le 6 ] && [ "$stop_stage" -ge 6 ]; then
  echo "=== stage 6: fine-tune of the TTS-pretrained VTN (PyTorch port)"
  ckpt=$(ls -t "$workdir/exp_aept_torch"/checkpoint-*steps.pt | head -1)
  python -m seq2seq_vc_torch.bin.vc_train \
    --src-train-dumpdir "$feats" --src-dev-dumpdir "$feats" \
    --trg-train-dumpdir "$feats" --trg-dev-dumpdir "$feats" \
    --init-checkpoint "$ckpt" \
    --outdir "$workdir/exp_tune_torch" --config "$workdir/exp_aept_torch/config.yml" \
    --additional-config "$workdir/conf_torch/vtn.tts_pt.synth.yaml" --device "$device"
fi

echo "=== synth TTS recipe (PyTorch port) done"
