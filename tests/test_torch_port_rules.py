"""Port: the rules every part of seq2seq_vc_torch keeps.

- The package and ``chip_smoke.py`` import neither JAX nor the JAX package,
  nor sklearn or transformers, which the card's machine lacks (checked in
  a fresh interpreter: this test process has them loaded).
- Entry points run on the card unless the caller names another device;
  without a card, one built without ``device=`` (a CLI without
  ``--device``, the feature CLIs and encoders included) raises.
- A wrapper takes its kernel's plain version only for a CPU tensor, and
  only a kernel launch counts: CPU calls, forward and backward, leave every
  counter at 0.
- ``chip_smoke.py`` without a card exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401 (release_jax_executables: autouse fixture)
    aasvc_pair,
    release_jax_executables,
    vtn_pair,
)
from seq2seq_vc_torch.bin import (compute_statistics, evaluate, normalize, preprocess,
                                  tts_decode, tts_train, vc_decode, vc_serve, vc_train,
                                  vocoder_anasyn_debug)
from seq2seq_vc_torch.dsp.features import LogMelExtractor, logmelfilterbank
from seq2seq_vc_torch.evaluate.asr import ASRTranscriber
from seq2seq_vc_torch.evaluate.wav2vec2 import load_wav2vec2
from seq2seq_vc_torch.encoders.encodec import load_encodec, load_encodec_decoder
from seq2seq_vc_torch.encoders.ppg import build_extractor, load_ppg_upstream
from seq2seq_vc_torch.models.fastspeech_vc import FastSpeechVC
from seq2seq_vc_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
    flash_bwd_dkv,
    flash_bwd_dq,
    rel_flash_attention,
    rel_flash_attention_plain,
    rel_flash_bwd_dkv,
    rel_flash_bwd_dpos,
    rel_flash_bwd_dq,
)
from seq2seq_vc_torch.ops.rel_scores import (
    fused_rel_scores,
    fused_rel_scores_plain,
    rel_band_bwd,
    rel_band_bwd_dpos,
    rel_band_bwd_dqv,
)
from seq2seq_vc_torch.pipeline import Wav2WavARConverter, Wav2WavConverter, resolve_device
from seq2seq_vc_torch.train.aas_vc import AASVCTrainer
from seq2seq_vc_torch.train.ar_vc import ARVCTrainer
from seq2seq_vc_torch.train.nar_vc import NARVCTrainer
from seq2seq_vc_torch.train.optim import build_optimizer
from seq2seq_vc_torch.train.state import TrainState
from seq2seq_vc_torch.vocoder.griffin_lim import Spectrogram2Waveform, griffin_lim
from seq2seq_vc_torch.urhythmic import cli as urhythmic_cli
from seq2seq_vc_torch.urhythmic.hubert import load_hubert_soft
from seq2seq_vc_torch.urhythmic.vocoder_train import HifiganTrainer
from seq2seq_vc_torch.vocoder.hifigan import HifiganGenerator, load_hifigan_backend
from seq2seq_vc_torch.vocoder.melgan import load_melgan_model
from seq2seq_vc_torch.vocoder.pwg import load_pwg_model
from seq2seq_vc_torch.vocoder.taco2ar import build_downstream
from seq2seq_vc_torch.vocoder.vocoder import get_vocoder

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import seq2seq_vc_torch
names = [m.name for m in pkgutil.walk_packages(seq2seq_vc_torch.__path__, "seq2seq_vc_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "seq2seq_vc_tpu", "sklearn", "transformers"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _inputs(B=2, H=2, T=20, D=8, seed=0):
    rng = np.random.default_rng(seed)
    qu, qv, k, v = (torch.from_numpy(rng.standard_normal((B, H, T, D)).astype(np.float32))
                    for _ in range(4))
    pos = torch.from_numpy(rng.standard_normal((H, 2 * T - 1, D)).astype(np.float32))
    return qu, qv, k, v, pos


COUNTED = (fused_rel_scores, rel_band_bwd, rel_flash_attention, rel_flash_bwd_dq,
           rel_flash_bwd_dkv, rel_flash_bwd_dpos, flash_attention, flash_bwd_dq, flash_bwd_dkv,
           rel_band_bwd_dqv, rel_band_bwd_dpos)
LEGACY_COUNTED = (rel_flash_attention, rel_flash_bwd_dq, rel_flash_bwd_dkv, rel_flash_bwd_dpos)


def _tiny_fastspeech_vc(**over):
    """FastSpeech-VC in the arctic conf's layout at toy widths, its
    attention on the flash backend."""
    torch.manual_seed(0)
    return FastSpeechVC(**dict(
        idim=80, odim=80, adim=32, aheads=2, elayers=1, eunits=64, dlayers=1, dunits=64,
        positionwise_layer_type="linear", encoder_type="conformer", decoder_type="conformer",
        encoder_input_layer="conv2d", duration_predictor_use_encoder_outputs=False,
        duration_predictor_chans=16, postnet_layers=2, postnet_chans=16,
        teacher_model_decoder_reduction_factor=1, attention_backend="flash", **over)).eval()


def _counts():
    return ([fn.launches for fn in COUNTED], [fn.legacy_launches for fn in LEGACY_COUNTED])


def _zero():
    for fn in COUNTED:
        fn.launches = 0
    for fn in LEGACY_COUNTED:
        fn.legacy_launches = 0


@pytest.fixture
def zero_counts():
    _zero()
    yield
    _zero()


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "seq2seq_vc_torch.pipeline" in got["modules"]
    assert "seq2seq_vc_torch.ops.flash_attention" in got["modules"]
    assert {"seq2seq_vc_torch.train.trainer", "seq2seq_vc_torch.train.data",
            "seq2seq_vc_torch.losses.forward_sum", "seq2seq_vc_torch.models.vtn",
            "seq2seq_vc_torch.models.ar_driver", "seq2seq_vc_torch.train.ar_vc",
            "seq2seq_vc_torch.losses.seq2seq", "seq2seq_vc_torch.bin.vc_train",
            "seq2seq_vc_torch.bin.vc_decode", "seq2seq_vc_torch.bin.vc_serve",
            "seq2seq_vc_torch.core.config", "seq2seq_vc_torch.utils.io",
            "seq2seq_vc_torch.vocoder.vocoder", "seq2seq_vc_torch.models.fastspeech_vc",
            "seq2seq_vc_torch.nn.duration_predictor", "seq2seq_vc_torch.losses.duration",
            "seq2seq_vc_torch.ops.upsampling",
            "seq2seq_vc_torch.train.nar_vc", "seq2seq_vc_torch.text.g2p_native",
            "seq2seq_vc_torch.text.g2p_backends", "seq2seq_vc_torch.models.transformer_tts",
            "seq2seq_vc_torch.train.ar_tts", "seq2seq_vc_torch.train.tts_data",
            "seq2seq_vc_torch.losses.guided_attention", "seq2seq_vc_torch.core.checkpoint",
            "seq2seq_vc_torch.bin.tokenize_text", "seq2seq_vc_torch.bin.tts_train",
            "seq2seq_vc_torch.bin.tts_decode", "seq2seq_vc_torch.bin.vocoder_anasyn_debug",
            "seq2seq_vc_torch.vocoder.common", "seq2seq_vc_torch.vocoder.pwg",
            "seq2seq_vc_torch.vocoder.melgan", "seq2seq_vc_torch.vocoder.taco2ar",
            "seq2seq_vc_torch.vocoder.s3prl_feat2wav", "seq2seq_vc_torch.bin.preprocess",
            "seq2seq_vc_torch.bin.compute_statistics", "seq2seq_vc_torch.bin.normalize",
            "seq2seq_vc_torch.encoders.ppg", "seq2seq_vc_torch.encoders.encodec",
            "seq2seq_vc_torch.vocoder.encodec_dec", "seq2seq_vc_torch.urhythmic.cli",
            "seq2seq_vc_torch.urhythmic.cluster", "seq2seq_vc_torch.urhythmic.hubert",
            "seq2seq_vc_torch.urhythmic.segmenter", "seq2seq_vc_torch.urhythmic.rhythm_model",
            "seq2seq_vc_torch.urhythmic.stretcher", "seq2seq_vc_torch.urhythmic.vocoder_train",
            "seq2seq_vc_torch.urhythmic.dataset",
            "seq2seq_vc_torch.urhythmic.model",
            "seq2seq_vc_torch.bin.convert_checkpoint", "seq2seq_vc_torch.nn.diffusion",
            "seq2seq_vc_torch.losses.diffsinger_l2", "seq2seq_vc_torch.losses.mle",
            "seq2seq_vc_torch.evaluate.wav2vec2", "seq2seq_vc_torch.evaluate.asr",
            "seq2seq_vc_torch.evaluate.harvest", "seq2seq_vc_torch.utils.plot",
            "seq2seq_vc_torch.bin.evaluate", "seq2seq_vc_torch.parallel",
            "seq2seq_vc_torch.parallel.mesh",
            "seq2seq_vc_torch.parallel.distributed", "seq2seq_vc_torch.parallel.collectives",
            "seq2seq_vc_torch.parallel.tp", "seq2seq_vc_torch.parallel.ring_attention",
            "seq2seq_vc_torch.parallel.pp", "seq2seq_vc_torch.parallel.plan"} <= set(got["modules"])
    assert got["bad"] == []


def test_entry_points_need_a_card_or_an_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    port, _, _ = aasvc_pair(seed=0)
    voc = HifiganGenerator(in_channels=80, upsample_channels=32,
                           resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),))
    stats = {"mean": np.zeros(80, np.float32), "scale": np.ones(80, np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Wav2WavConverter(port, voc, stats, stats, {})
    assert Wav2WavConverter(port, voc, stats, stats, {}, device="cpu").device.type == "cpu"
    state = TrainState(port, build_optimizer(port.parameters()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AASVCTrainer(state, {}, {"train_max_steps": 1}, [])
    assert AASVCTrainer(state, {}, {"train_max_steps": 1}, [], device="cpu").device.type == "cpu"
    vtn, _, _ = vtn_pair(seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Wav2WavARConverter(vtn, voc, stats, stats, {})
    assert Wav2WavARConverter(vtn, voc, stats, stats, {}, device="cpu").device.type == "cpu"
    state = TrainState(vtn, build_optimizer(vtn.parameters()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ARVCTrainer(state, {}, {"train_max_steps": 1}, [])
    assert ARVCTrainer(state, {}, {"train_max_steps": 1}, [], device="cpu").device.type == "cpu"
    fs2 = _tiny_fastspeech_vc()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Wav2WavConverter(fs2, voc, stats, stats, {})
    assert Wav2WavConverter(fs2, voc, stats, stats, {}, device="cpu").device.type == "cpu"
    state = TrainState(fs2, build_optimizer(fs2.parameters()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NARVCTrainer(state, {}, {"train_max_steps": 1}, [])
    assert NARVCTrainer(state, {}, {"train_max_steps": 1}, [], device="cpu").device.type == "cpu"
    # the command-line entry points: no --device, no card -> they raise first
    for main, argv in ((vc_train.main, ["--src-train-dumpdir", "x", "--src-dev-dumpdir", "x",
                                        "--trg-train-dumpdir", "x", "--trg-dev-dumpdir", "x",
                                        "--outdir", "x", "--config", "x"]),
                       (vc_decode.main, ["--dumpdir", "x", "--checkpoint", "x", "--outdir", "x"]),
                       (vc_decode.main, ["--dumpdir", "x", "--checkpoint", "x", "--outdir", "x",
                                         "--data-parallel", "2", "--batch-size", "2"]),
                       (vc_serve.main, ["--checkpoint", "x", "--src-stats", "x", "--trg-stats",
                                        "x", "--vocoder-checkpoint", "x"]),
                       (tts_train.main, ["--train-dumpdir", "x", "--dev-dumpdir", "x",
                                         "--train-text", "x", "--dev-text", "x",
                                         "--token-list", "x", "--outdir", "x", "--config", "x"]),
                       (tts_decode.main, ["--text", "x", "--checkpoint", "x", "--token-list",
                                          "x", "--outdir", "x"]),
                       (vocoder_anasyn_debug.main, ["--rootdir", "x", "--config", "x",
                                                    "--outdir", "x"]),
                       (preprocess.main, ["--wav-scp", "x", "--dumpdir", "x", "--config", "x"]),
                       (compute_statistics.main, ["--rootdir", "x", "--config", "x",
                                                  "--dumpdir", "x"]),
                       (normalize.main, ["--rootdir", "x", "--dumpdir", "x", "--stats", "x"]),
                       (evaluate.main, ["--wavdir", "x", "--gt-wavdir", "x"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
    # urhythmic's six subcommands, the host-only ones included
    for argv in (["resample", "--in-dir", "x", "--out-dir", "x"],
                 ["encode", "--in-dir", "x", "--out-dir", "x", "--hubert-checkpoint", "x"],
                 ["segment", "--logprob-dir", "x", "--out-dir", "x",
                  "--segmenter-checkpoint", "x"],
                 ["train-rhythm-model", "--out-path", "x"],
                 ["fine-tune-vocoder", "--wav-dir", "x", "--unit-dir", "x",
                  "--checkpoint-dir", "x"],
                 ["convert", "--in-dir", "x", "--out-dir", "x", "--segmenter-checkpoint", "x",
                  "--rhythm-model-checkpoint", "x", "--vocoder-checkpoint", "x"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            urhythmic_cli.main(argv)
    # the helpers under them: log-mels, the feature encoders, the vocoders
    spc = np.ones((4, 513), np.float32)
    for helper in (lambda: logmelfilterbank(np.zeros(1024, np.float32), 16000),
                   lambda: LogMelExtractor(16000), lambda: load_ppg_upstream("x"),
                   lambda: build_extractor("x", "x"), lambda: load_encodec("x"),
                   lambda: load_encodec_decoder("x"),
                   lambda: get_vocoder({"vocoder": {"vocoder_type": "encodec",
                                                    "checkpoint": "x"}}),
                   lambda: get_vocoder({}),
                   lambda: load_pwg_model("x"), lambda: load_melgan_model("x"),
                   lambda: build_downstream("x", {}, np.zeros(80), np.ones(80)),
                   lambda: Spectrogram2Waveform(16000, 1024, 256),
                   lambda: griffin_lim(spc, 1024, 256, n_iter=0),
                   lambda: load_hubert_soft("x"), lambda: HifiganTrainer(),
                   lambda: load_wav2vec2("x"), lambda: ASRTranscriber("x"),
                   lambda: load_hifigan_backend("x")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            helper()
    assert griffin_lim(spc, 1024, 256, n_iter=0, device="cpu").shape == (4 * 256,)


def test_cpu_tensors_take_the_plain_versions(zero_counts):
    qu, qv, k, v, pos = _inputs()
    lens = torch.tensor([20, 7])
    torch.testing.assert_close(fused_rel_scores(qu, qv, k, pos),
                               fused_rel_scores_plain(qu, qv, k, pos), rtol=0, atol=0)
    torch.testing.assert_close(rel_flash_attention(qu, qv, k, v, pos, lens),
                               rel_flash_attention_plain(qu, qv, k, v, pos, lens),
                               rtol=0, atol=0)
    # a whole model whose attention routes to both kernels
    port, _, _ = aasvc_pair(seed=0, port_kw=dict(attention_backend="flash", flash_min_len=40))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 48, 80)).astype(np.float32))
    port.inference(x, torch.tensor([48]), x, max_output_frames=64)
    # and the backward of both routes, the flash one with dropout
    ts = [t.requires_grad_() for t in (qu, qv, k, v, pos)]
    rel_flash_attention(*ts, lens, dropout_rate=0.2, dropout_seed=3).sum().backward()
    fused_rel_scores(*ts[:3], ts[4], bwd="banded").sum().backward()
    assert all(t.grad is not None for t in ts)
    # the standard flash kernels: a cross shape, forward and backward, and a
    # whole VTN whose encoder routes to them, decoding
    torch.testing.assert_close(flash_attention(qu[:, :, :9], k, v, lens, causal=True),
                               flash_attention_plain(qu[:, :, :9], k, v, lens, causal=True),
                               rtol=0, atol=0)
    ts = [t.detach().requires_grad_() for t in (qu, k, v)]
    flash_attention(*ts, lens, dropout_rate=0.2, dropout_seed=3).sum().backward()
    assert all(t.grad is not None for t in ts)
    vtn, _, _ = vtn_pair(seed=0, port_kw=dict(attention_backend="flash", flash_min_len=8))
    vtn.inference(x, torch.tensor([48]), maxlenratio=1.0)
    # the legacy form of the rel-pos flash kernels, forward and backward, and
    # a legacy AAS-VC whose attention routes to them
    ts = [t.detach().requires_grad_() for t in (qu, qv, k, v)]
    legacy_pos = pos[:, :20].detach().requires_grad_()
    rel_flash_attention(*ts, legacy_pos, lens, dropout_rate=0.2, dropout_seed=3,
                        legacy=True).sum().backward()
    assert legacy_pos.grad is not None and all(t.grad is not None for t in ts)
    legacy, _, _ = aasvc_pair(seed=0, port_kw=dict(attention_backend="flash", flash_min_len=40),
                              conformer_rel_pos_type="legacy")
    legacy.inference(x, torch.tensor([48]), x, max_output_frames=64)
    # FastSpeech-VC's conformer: the encoder (11 frames after the conv2d
    # subsampling) on the fused route, the decoder on the flash route
    _tiny_fastspeech_vc(flash_min_len=40).inference(x, torch.tensor([48]), x,
                                                    max_output_frames=64)
    # the bwd="pallas" pair, alone and under autograd
    g = torch.randn(2, 2, 20, 20)
    assert rel_band_bwd_dqv(g, qv, pos).shape == qv.shape
    assert rel_band_bwd_dpos(g, qv, pos).shape == pos.shape
    ts = [t.detach().requires_grad_() for t in (qu, qv, k, pos)]
    fused_rel_scores(*ts, bwd="pallas").sum().backward()
    assert all(t.grad is not None for t in ts)
    assert _counts() == ([0] * len(COUNTED), [0] * len(LEGACY_COUNTED))


def test_other_devices_are_refused():
    qu, qv, k, v, pos = (t.to("meta") for t in _inputs())
    with pytest.raises(ValueError, match="unsupported device"):
        fused_rel_scores(qu, qv, k, pos)
    with pytest.raises(ValueError, match="unsupported device"):
        rel_flash_attention(qu, qv, k, v, pos)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(qu, k, v)


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no card, even where there is one
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

