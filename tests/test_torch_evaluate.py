"""Port: objective evaluation (seq2seq_vc_torch/evaluate/, bin/evaluate.py)
against the JAX package's on seeded signals, and the port's native
wav2vec2 for CTC against the JAX package's ``ASRTranscriber``.

The host metrics (DTW, the mel-cepstrum and power chain, Harvest,
``calculate_mcd_f0``, the error rates) are copies: they must give the same
numbers. The wav2vec2 is a tiny ``transformers`` model at seeded weights
(its CTC head scaled by 10, so that an argmax is never a near-tie), saved
in Hugging Face's directory layout with its processor: for
``feat_extract_norm: layer`` with the stable layer norm, JAX's transcriber
runs the flax model converted from those weights (its bucketed, masked
path), for ``group`` (which flax does not build) it runs the injected torch
model at the exact length. The port's logits on the valid frames are held
to atol 1e-4 (float32 sums in another order through two layers), and the
transcripts must be equal. ``bin/evaluate`` is held against
``seq2seq_vc_tpu.bin.evaluate`` on the same wav directories: the same
``--out`` lines within 1e-4.
"""

import json
import shutil
import sys

import numpy as np
import pytest
import torch

from _torch_port import release_jax_executables  # noqa: F401 (autouse fixture)
from make_world_goldens import FS, harmonic
from seq2seq_vc_tpu.evaluate import asr as jax_asr
from seq2seq_vc_tpu.evaluate import dtw_based as jax_dtw_based
from seq2seq_vc_tpu.evaluate import harvest as jax_harvest
from seq2seq_vc_tpu.evaluate import signal as jax_signal
from seq2seq_vc_tpu.evaluate.dtw import dtw_path as jax_dtw_path
from seq2seq_vc_tpu.utils.audio import write_wav as jax_write_wav
from seq2seq_vc_torch.bin import evaluate as port_evaluate
from seq2seq_vc_torch.evaluate import asr, dtw_based, harvest, signal
from seq2seq_vc_torch.evaluate.dtw import dtw_path
from seq2seq_vc_torch.evaluate.wav2vec2 import (
    Processor,
    load_safetensors,
    load_wav2vec2,
    save_safetensors,
)

LOGIT_ATOL = 1e-4
VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4, "A": 5, "B": 6, "C": 7}


def _speech(seconds: float, seed: int) -> np.ndarray:
    track = np.linspace(110 + 20 * seed, 230, int(seconds * FS))
    rng = np.random.default_rng(seed)
    return (harmonic(track) + 0.01 * rng.standard_normal(len(track))).astype(np.float32)


# --------------------------------------------------------- the host metrics
def test_dtw_matches_jax():
    rng = np.random.default_rng(0)
    for t1, t2 in ((23, 31), (40, 17)):
        x, y = rng.standard_normal((t1, 5)), rng.standard_normal((t2, 5))
        got, want = dtw_path(x, y), jax_dtw_path(x, y)
        assert got[0] == want[0] and got[1] == want[1]


def test_analysis_chain_and_harvest_match_jax():
    x = _speech(0.6, 1).astype(np.float64)
    for name in ("low_cut_filter",):
        np.testing.assert_array_equal(getattr(signal, name)(x, FS),
                                      getattr(jax_signal, name)(x, FS))
    sp = signal.spectral_envelope(x, FS)
    np.testing.assert_array_equal(sp, jax_signal.spectral_envelope(x, FS))
    np.testing.assert_array_equal(signal.spc2npow(sp), jax_signal.spc2npow(sp))
    np.testing.assert_array_equal(signal.sp2mc(sp, 24, 0.41), jax_signal.sp2mc(sp, 24, 0.41))
    np.testing.assert_array_equal(harvest.harvest_f0(x, FS, 70, 400),
                                  jax_harvest.harvest_f0(x, FS, 70, 400))
    got, want = signal.world_extract(x, FS, 70, 400), jax_signal.world_extract(x, FS, 70, 400)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_calculate_mcd_f0_and_error_rates_match_jax():
    a, b = _speech(0.8, 2), _speech(0.9, 3)
    got = dtw_based.calculate_mcd_f0(a, b, FS, 70, 400)
    want = jax_dtw_based.calculate_mcd_f0(a, b, FS, 70, 400)
    assert got == want
    pairs = [("THE CAT SAT", "the cat sat."), ("HELO WORLD", "hello, world"), ("", "a b"),
             ("A B C D", ""), ("IT'S OK", "its ok")]
    for hyp, ref in pairs:
        assert asr.normalize_text(ref) == jax_asr.normalize_text(ref)
        assert asr.character_error_rate(hyp, ref) == jax_asr.character_error_rate(hyp, ref)
        assert asr.word_error_rate(hyp, ref) == jax_asr.word_error_rate(hyp, ref)
        assert asr.levenshtein(list(hyp), list(ref)) == jax_asr.levenshtein(list(hyp), list(ref))


# ------------------------------------------------------------ wav2vec2-CTC
def _hf_dir(root, norm: str, seed: int = 0):
    """A tiny seeded ``transformers`` wav2vec2 CTC model and its processor,
    saved in HF's layout (``model.safetensors``); returns (dir, torch model,
    processor)."""
    transformers = pytest.importorskip("transformers")
    root.mkdir(parents=True, exist_ok=True)
    (root / "vocab.json").write_text(json.dumps(VOCAB))
    tokenizer = transformers.Wav2Vec2CTCTokenizer(str(root / "vocab.json"))
    fe = transformers.Wav2Vec2FeatureExtractor(feature_size=1, sampling_rate=16000,
                                               padding_value=0.0, do_normalize=True,
                                               return_attention_mask=norm == "layer")
    processor = transformers.Wav2Vec2Processor(feature_extractor=fe, tokenizer=tokenizer)
    config = transformers.Wav2Vec2Config(
        vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
        num_feat_extract_layers=2, do_stable_layer_norm=norm == "layer",
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, feat_extract_norm=norm,
        conv_bias=norm == "layer")
    torch.manual_seed(seed)
    model = transformers.Wav2Vec2ForCTC(config).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
            if name.startswith("lm_head"):
                p.mul_(10.0)
    model.save_pretrained(root)
    processor.save_pretrained(root)
    return root, model, processor


@pytest.mark.parametrize("norm", ["layer", "group"])
def test_wav2vec2_ctc_matches_jax_transcriber(tmp_path, norm):
    root, hf_model, processor = _hf_dir(tmp_path / "w2v", norm)
    if norm == "layer":  # JAX's TPU path: flax, bucketed and masked
        from transformers import FlaxWav2Vec2ForCTC

        ref = jax_asr.ASRTranscriber(model=FlaxWav2Vec2ForCTC.from_pretrained(root, from_pt=True),
                                     processor=processor)
        assert ref.backend == "flax"
    else:  # flax builds no group-norm feature encoder: the torch backend
        ref = jax_asr.ASRTranscriber(model=hf_model, processor=processor)
        assert ref.backend == "torch"
    port = asr.ASRTranscriber(str(root), device="cpu")
    for seconds, seed in ((0.4, 0), (1.3, 1), (2.0, 2)):
        audio = _speech(seconds, seed)
        iv = processor(audio, sampling_rate=16000, return_tensors="np").input_values
        if norm == "layer":
            want = ref._flax_logits(iv)[0]
        else:
            with torch.no_grad():
                want = hf_model(torch.from_numpy(iv)).logits[0].numpy()
        got = port.logits(audio).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
        text = port.transcribe(audio)
        assert text == ref.transcribe(audio)
        # the port's processor decodes as transformers' tokenizer does
        ids = want.argmax(-1)
        assert Processor(str(root)).decode(ids) == processor.batch_decode(ids[None])[0]


def test_wav2vec2_reads_both_weight_files_and_weight_norm_forms(tmp_path):
    root, _, _ = _hf_dir(tmp_path / "st", "layer")
    assert (root / "model.safetensors").exists()
    from_st = load_wav2vec2(str(root), "cpu")
    # a pytorch_model.bin in the older weight-norm names, no safetensors
    bin_dir = tmp_path / "bin"
    shutil.copytree(root, bin_dir)
    (bin_dir / "model.safetensors").unlink()
    sd = load_safetensors(str(root / "model.safetensors"))
    p = "wav2vec2.encoder.pos_conv_embed.conv"
    sd[f"{p}.weight_g"] = sd.pop(f"{p}.parametrizations.weight.original0")
    sd[f"{p}.weight_v"] = sd.pop(f"{p}.parametrizations.weight.original1")
    torch.save(sd, bin_dir / "pytorch_model.bin")
    from_bin = load_wav2vec2(str(bin_dir), "cpu")
    for k, v in from_st.state_dict().items():
        assert torch.equal(v, from_bin.state_dict()[k]), k
    # the writer round-trips through the safetensors package's reader
    safetensors = pytest.importorskip("safetensors.torch")
    save_safetensors(str(tmp_path / "x.safetensors"), sd)
    theirs = safetensors.load_file(str(tmp_path / "x.safetensors"))
    assert sorted(theirs) == sorted(sd) and all(torch.equal(theirs[k], sd[k]) for k in sd)


# ------------------------------------------------------------ bin/evaluate
def _wav_dirs(root):
    cvt, gt = root / "cvt", root / "gt"
    cvt.mkdir(parents=True)
    gt.mkdir()
    texts = []
    for i, (a, b) in enumerate(((0.7, 0.8), (0.9, 0.75), (0.6, 0.6))):
        jax_write_wav(str(cvt / f"u{i}.wav"), _speech(a, i), FS)
        jax_write_wav(str(gt / f"u{i}.wav"), _speech(b, i + 5), FS)
        texts.append(f"u{i} ABC CAB")
    (root / "text").write_text("\n".join(texts) + "\n")
    return cvt, gt


def _jax_main(monkeypatch, argv):
    from seq2seq_vc_tpu.bin import evaluate as jax_evaluate

    monkeypatch.setenv("S2S_JAX_CACHE_DIR", "")
    monkeypatch.setattr(sys, "argv", ["evaluate"] + argv)
    jax_evaluate.main()


def _read(path):
    return {line.split()[0]: np.array(line.split()[1:], float)
            for line in path.read_text().splitlines()}


def test_bin_evaluate_matches_jax(tmp_path, monkeypatch):
    cvt, gt = _wav_dirs(tmp_path)
    (tmp_path / "f0.yaml").write_text("spk: {f0min: 70, f0max: 400}\n")
    common = ["--wavdir", str(cvt), "--gt-wavdir", str(gt), "--f0-yaml",
              str(tmp_path / "f0.yaml"), "--spk", "spk"]
    _jax_main(monkeypatch, common + ["--n-jobs", "1", "--out", str(tmp_path / "jax.txt")])
    means = port_evaluate.main(common + ["--n-jobs", "2", "--out", str(tmp_path / "port.txt"),
                                         "--device", "cpu"])
    want, got = _read(tmp_path / "jax.txt"), _read(tmp_path / "port.txt")
    assert sorted(got) == sorted(want) == ["u0", "u1", "u2"]
    for utt in want:
        np.testing.assert_allclose(got[utt], want[utt], atol=1e-4, rtol=0, err_msg=utt)
    np.testing.assert_allclose(means["MCD"], np.mean([v[0] for v in want.values()]), atol=1e-4)

    # the ASR ceiling on the ground truth through both CLIs, one local
    # model directory (the flax one converted from its torch weights)
    root, _, _ = _hf_dir(tmp_path / "w2v", "layer")
    asr_args = ["--wavdir", str(cvt), "--gt-wavdir", str(gt), "--transcription",
                str(tmp_path / "text"), "--asr-model", str(root), "--gt-ceiling"]
    _jax_main(monkeypatch, asr_args + ["--out", str(tmp_path / "jax_gt.txt")])
    means = port_evaluate.main(asr_args + ["--out", str(tmp_path / "port_gt.txt"),
                                           "--device", "cpu"])
    want, got = _read(tmp_path / "jax_gt.txt"), _read(tmp_path / "port_gt.txt")
    assert sorted(got) == sorted(want) and len(want) == 3
    for utt in want:
        np.testing.assert_array_equal(got[utt], want[utt])
    assert set(means) == {"CER", "WER"}
