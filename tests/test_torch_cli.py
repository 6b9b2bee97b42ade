"""Port: the command-line entry points (seq2seq_vc_torch/bin: vc_train,
vc_decode, vc_serve) and the modules they brought in (core/config.py,
dsp/stats.py, dsp/features.logmelfilterbank, utils/, vocoder/griffin_lim.py,
vocoder/vocoder.py, the registries, ``Trainer.generate_intermediate``),
against the JAX package on the CPU.

- Configs: the port's ``load_config`` and the JAX one agree exactly on every
  ``egs/**/conf/*.yaml``; ``dump_config`` -> ``load_config`` round-trips.
- Decoding: flax parameters from the JAX package's own init (its
  ``bin/vc_train.init_model_params``), plus seeded noise so that the
  zero-initialised flows take part, go to a port checkpoint through
  ``seq2seq_vc_torch/convert.py``; ``vc_decode.main`` writes features that
  must match the JAX model's inference on the same parameters and padded
  inputs. AAS-VC: the tiny synth conf (egs/synth/vc1/conf/aas_vc.synth.yaml)
  with the duration predictor's noise scale 0 and float32 compute on both
  sides (bf16 rounds differently in the two frameworks); durations exactly,
  features at atol 1e-4 and rtol 1e-4 as tests/test_torch_aas_vc.py holds
  inference. VTN: vtn.v1.yaml's structure at toy widths, prenet dropout 0,
  threshold 1.1 (never stops: no stop decision can flip), against the JAX
  ``ChunkedARDecoder``; lengths exactly, features at atol 1e-4 as
  tests/test_torch_vtn.py holds AR decodes; teacher forcing: the attention
  maps at atol 1e-5, the features at atol 2e-5, the durations identical to
  the JAX ``calculate_durations`` of the JAX maps.
- Training: ``vc_train.main`` for 2 steps then ``--resume`` to 4 gives the
  same parameters, bit for bit, as 4 straight steps (dropout off; the
  loader's position and the generators' states ride in the checkpoint).
- Griffin-Lim with the JAX function's initial phases injected: atol 1e-6
  (waveforms of magnitude ~0.1; measured ~1e-7).
- Serving: stdio through ``vc_serve.main`` on a tiny AAS-VC, TCP with a
  stand-in converter: the JSON lines, the micro-batch padding, the warm-up
  of every batch size the dispatcher can form.
"""

import contextlib
import importlib
import io
import json
import logging
import socket
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from _torch_port import release_jax_executables  # noqa: F401 (autouse fixture)
from seq2seq_vc_tpu.bin.vc_train import init_model_params
from seq2seq_vc_tpu.core import config as jax_config
from seq2seq_vc_tpu.dsp.features import logmelfilterbank as jax_logmel
from seq2seq_vc_tpu.models import AASVC as JaxAASVC
from seq2seq_vc_tpu.models import VTN as JaxVTN
from seq2seq_vc_tpu.models import ar_driver as jax_ar_driver
from seq2seq_vc_tpu.utils import audio as jax_audio
from seq2seq_vc_tpu.utils.duration_calculator import calculate_durations as jax_durations
from seq2seq_vc_tpu.utils.io import write_hdf5 as jax_write_hdf5
from seq2seq_vc_torch.bin import vc_decode, vc_serve, vc_train
from seq2seq_vc_torch.convert import aasvc_state_dict, vtn_state_dict
from seq2seq_vc_torch.core.config import dump_config, load_config
from seq2seq_vc_torch.dsp.features import logmelfilterbank
from seq2seq_vc_torch.models import get_model_class
from seq2seq_vc_torch.models.aas_vc import AASVC
from seq2seq_vc_torch.models.vtn import VTN
from seq2seq_vc_torch.train import get_trainer_class
from seq2seq_vc_torch.utils import audio
from seq2seq_vc_torch.utils.duration_calculator import calculate_durations
from seq2seq_vc_torch.utils.io import read_stats, write_stats
from seq2seq_vc_torch.vocoder import griffin_lim as port_gl
from seq2seq_vc_torch.vocoder.hifigan import HifiganGenerator
from seq2seq_vc_torch.vocoder.vocoder import get_vocoder

jax_gl = importlib.import_module("seq2seq_vc_tpu.vocoder.griffin_lim")  # the package
# re-exports a function of the same name
REPO = Path(__file__).resolve().parents[1]
CONFS = sorted(str(p.relative_to(REPO)) for p in REPO.glob("egs/**/conf/*.yaml"))
SYNTH = REPO / "egs/synth/vc1/conf/aas_vc.synth.yaml"
VTN_CONF = REPO / "egs/arctic/vc1/conf/vtn.v1.yaml"
TOL = dict(atol=1e-4, rtol=1e-4)
AR_TOL = dict(atol=1e-4, rtol=0)
# vtn.v1.yaml's model at toy widths, the prenet's dropout 0 (its always-on
# bits cannot be reproduced across frameworks)
TINY_VTN = dict(adim=32, aheads=2, elayers=2, eunits=64, dlayers=2, dunits=64,
                dprenet_units=24, postnet_layers=2, postnet_chans=16, dprenet_dropout_rate=0.0)
NO_DROPOUT = {k: 0.0 for k in (
    "transformer_enc_dropout_rate", "transformer_enc_positional_dropout_rate",
    "transformer_enc_attn_dropout_rate", "transformer_dec_dropout_rate",
    "transformer_dec_positional_dropout_rate", "transformer_dec_attn_dropout_rate")}


# ------------------------------------------------------------------ helpers
def _write_feats(root: Path, name: str, lens, seed: int) -> str:
    """Random log-mel-like features as ``.npy`` files and their scp."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    lines = []
    for i, n in enumerate(lens):
        path = root / f"{name}_{i}.npy"
        np.save(path, (-4 + rng.standard_normal((n, 80))).astype(np.float32))
        lines.append(f"utt{i} {path}")
    scp = root / f"{name}.scp"
    scp.write_text("\n".join(lines) + "\n")
    return str(scp)


def _conf(path: Path, **model_params):
    config = load_config(str(path))
    config["model_params"] = dict(config["model_params"], **model_params)
    return config


def _perturbed(tree, seed: int, scale: float = 0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(np.shape(a))).astype(np.float32),
        tree)


def _export(tmp_path: Path, config, jax_model, sample, to_port) -> str:
    """JAX-initialised (and perturbed) parameters -> a port checkpoint with
    the config beside it; returns the checkpoint's path and the flax tree."""
    flax = _perturbed(init_model_params(jax_model, config, sample), seed=3)
    port = get_model_class(config["model_type"])(**config["model_params"])
    port.load_state_dict(to_port(flax, port))
    exp = tmp_path / "exp"
    exp.mkdir()
    (exp / "config.yml").write_text(yaml.safe_dump(config))
    torch.save({"model": port.state_dict()}, exp / "checkpoint-0steps.pt")
    return str(exp / "checkpoint-0steps.pt"), flax


def _groups(lens, batch_size):
    """vc_decode's batches: indices sorted by source length, in chunks."""
    order = sorted(range(len(lens)), key=lambda i: (lens[i], i))
    return [order[i: i + batch_size] for i in range(0, len(order), batch_size)]


def _padded(feats, multiple):
    t = -(-max(len(f) for f in feats) // multiple) * multiple
    out = np.zeros((len(feats), t, 80), np.float32)
    for i, f in enumerate(feats):
        out[i, : len(f)] = f
    return out


def _scp_arrays(scp: str):
    return {line.split()[0]: np.load(line.split()[1]) for line in open(scp).read().splitlines()}


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("conf", CONFS)
def test_load_config_matches_jax(conf):
    assert load_config(str(REPO / conf)) == jax_config.load_config(str(REPO / conf))


def test_dump_config_round_trips(tmp_path):
    config = dict(load_config(str(SYNTH)), outdir=str(tmp_path), seed=np.int64(3),
                  lens=(1, 2), path=tmp_path)
    path = dump_config(config, str(tmp_path), "0.1.0")
    back = load_config(path)
    assert back == jax_config.load_config(jax_config.dump_config(config, str(tmp_path / "j"),
                                                                 "0.1.0"))
    assert back["seed"] == 3 and back["lens"] == [1, 2] and back["path"] == str(tmp_path)
    assert back["version"] == "0.1.0" and back["model_params"] == config["model_params"]


# ---------------------------------------------------------- host modules
def test_stats_npz_and_h5_give_the_same_arrays(tmp_path):
    rng = np.random.default_rng(0)
    mean, scale = rng.standard_normal(80), rng.random(80) + 0.5
    write_stats(str(tmp_path / "stats.npz"), mean, scale, "mel")
    jax_write_hdf5(str(tmp_path / "stats.h5"), "mel_mean", mean)  # as compute_statistics writes
    jax_write_hdf5(str(tmp_path / "stats.h5"), "mel_scale", scale)
    write_stats(str(tmp_path / "port.h5"), mean, scale)
    a, b = read_stats(str(tmp_path / "stats.npz"), "mel"), read_stats(str(tmp_path / "stats.h5"),
                                                                        "mel")
    c = read_stats(str(tmp_path / "port.h5"))
    for k in ("mean", "scale"):
        assert a[k].dtype == b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a[k], c[k])


def test_audio_io_resample_and_logmel_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    x = (0.3 * np.sin(np.arange(20800) * 0.05) + 0.01 * rng.standard_normal(20800))
    x = x.astype(np.float32)
    audio.write_wav(str(tmp_path / "a.wav"), x, 16000)
    jax_audio.write_wav(str(tmp_path / "b.wav"), x, 16000)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    y, sr = audio.read_wav(str(tmp_path / "a.wav"))
    np.testing.assert_array_equal(y, jax_audio.read_wav(str(tmp_path / "a.wav"))[0])
    assert sr == 16000
    from seq2seq_vc_tpu.bin.preprocess import resample as jax_resample

    np.testing.assert_array_equal(audio.resample(y, 16000, 22050), jax_resample(y, 16000, 22050))
    got = logmelfilterbank(y, 16000, fmin=80, fmax=7600, device="cpu")
    want = jax_logmel(y, 16000, fmin=80, fmax=7600)
    assert got.shape == want.shape == (1 + len(y) // 256, 80)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)  # log10 of float32 sums


def test_registries_name_the_roadmap_item_of_what_is_not_ported():
    assert get_model_class("AASVC") is AASVC and get_model_class("VTN") is VTN
    assert get_model_class("FastSpeechVC").__name__ == "FastSpeechVC"
    for name in ("AASVCTrainer", "ARVCTrainer", "NARVCTrainer"):
        assert get_trainer_class(name).__name__ == name
    assert get_model_class("TransformerTTS").__name__ == "TransformerTTS"
    assert get_trainer_class("ARTTSTrainer").__name__ == "ARTTSTrainer"
    with pytest.raises(ValueError):
        get_model_class("Nope")
    with pytest.raises(ValueError, match="encodec' needs `checkpoint:`"):
        get_vocoder({"vocoder": {"vocoder_type": "encodec"}}, device="cpu")


@pytest.mark.parametrize("n_iter", [0, 32])
def test_griffin_lim_with_injected_phases_matches_jax(n_iter):
    rng = np.random.default_rng(n_iter)
    lmspc = (-3 + 0.5 * rng.standard_normal((40, 80))).astype(np.float32)
    spc = port_gl.logmel2linear(lmspc, 16000, 1024, 80, 80, 7600)
    np.testing.assert_array_equal(spc, jax_gl.logmel2linear(lmspc, 16000, 1024, 80, 80, 7600))
    angles = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), spc.shape))  # jax's draw
    want = jax_gl.griffin_lim(spc, 1024, 256, n_iter=n_iter, seed=0)
    got = port_gl.griffin_lim(spc, 1024, 256, n_iter=n_iter, angles=angles, device="cpu")
    assert got.shape == want.shape == (40 * 256,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# -------------------------------------------------------------- vc_decode
LENS = [37, 50, 44]


def test_vc_decode_nar_matches_jax_inference(tmp_path):
    config = _conf(SYNTH, compute_dtype="float32", stochastic_duration_predictor_noise_scale=0.0)
    jax_model = JaxAASVC(**config["model_params"])
    feats = _write_feats(tmp_path, "src", LENS, seed=0)
    src = _scp_arrays(feats)
    x = src["utt0"]
    sample = {"xs": x[None, :36], "ilens": np.array([36]), "ys": x[None, :36],
              "olens": np.array([36]), "dp_inputs": x[None, :36], "dplens": np.array([36])}
    ckpt, flax = _export(tmp_path, dict(config, collater_type="NARVCCollater"), jax_model,
                         sample, aasvc_state_dict)
    out = tmp_path / "out"
    vc_decode.main(["--dumpdir", feats, "--dp-input-dir", feats, "--checkpoint", ckpt,
                    "--outdir", str(out), "--batch-size", "2", "--device", "cpu"])
    got = _scp_arrays(str(out / "feats.scp"))
    infer = jax.jit(lambda p, xs, ilens: jax_model.apply(
        p, xs, ilens, xs, max_output_frames=2 * xs.shape[1], method=JaxAASVC.inference,
        rngs={"noise": jax.random.PRNGKey(0)}))
    for group in _groups(LENS, 2):
        xs = _padded([src[f"utt{i}"] for i in group], vc_decode.BUCKET_FRAMES)
        ref = infer(flax, xs, np.array([LENS[i] for i in group]))
        for b, i in enumerate(group):
            n = int(ref["out_lens"][b])
            assert got[f"utt{i}"].shape == (n, 80)
            np.testing.assert_allclose(got[f"utt{i}"], np.asarray(ref["outs"])[b, :n], **TOL)
            dur = np.loadtxt(out / "durations" / f"utt{i}.txt", dtype=np.int64, ndmin=1)
            d_outs = np.asarray(ref["d_outs"])[b, : int(ref["d_lens"][b])]
            np.testing.assert_array_equal(dur, d_outs)
            wav, sr = audio.read_wav(str(out / "wav" / f"utt{i}.wav"))  # Griffin-Lim
            assert sr == 16000 and len(wav) == n * 256


def _vtn_export(tmp_path):
    config = _conf(VTN_CONF, **TINY_VTN)
    config["inference"] = dict(config["inference"], threshold=1.1, maxlenratio=2.0)
    jax_model = JaxVTN(**config["model_params"])
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 40, 80)).astype(np.float32)
    sample = {"xs": x, "ilens": np.array([40]), "ys": x, "olens": np.array([40]),
              "labels": np.zeros((1, 40), np.float32)}
    ckpt, flax = _export(tmp_path, config, jax_model, sample, vtn_state_dict)
    return config, jax_model, ckpt, flax


def test_vc_decode_ar_matches_the_jax_chunked_decoder(tmp_path):
    config, jax_model, ckpt, flax = _vtn_export(tmp_path)
    feats = _write_feats(tmp_path, "src", LENS, seed=1)
    out = tmp_path / "out"
    vc_decode.main(["--dumpdir", feats, "--checkpoint", ckpt, "--outdir", str(out),
                    "--batch-size", "2", "--device", "cpu"])
    got = _scp_arrays(str(out / "feats.scp"))
    src = _scp_arrays(feats)
    inf = config["inference"]
    drv = jax_ar_driver.ChunkedARDecoder(jax_model, JaxVTN, threshold=inf["threshold"],
                                         minlenratio=inf["minlenratio"],
                                         maxlenratio=inf["maxlenratio"])
    for group in _groups(LENS, 2):
        xs = _padded([src[f"utt{i}"] for i in group], vc_decode.BUCKET_FRAMES)
        est = int(np.ceil(1.2 * max(LENS[i] for i in group) / 4))
        ref = drv(flax, xs, np.array([LENS[i] for i in group]), jax.random.PRNGKey(0),
                  est_steps=est)
        for b, i in enumerate(group):
            n = int(ref["out_lens"][b])
            assert got[f"utt{i}"].shape == (n, 80)
            np.testing.assert_allclose(got[f"utt{i}"], np.asarray(ref["outs"])[b, :n], **AR_TOL)
            assert (out / "wav" / f"utt{i}.wav").exists()


def test_vc_decode_teacher_forcing_durations_match_jax(tmp_path):
    config, jax_model, ckpt, flax = _vtn_export(tmp_path)
    src = _write_feats(tmp_path, "src", LENS, 2)
    trg = _write_feats(tmp_path, "trg", [41, 52, 46], 3)
    out = tmp_path / "out"
    vc_decode.main(["--dumpdir", src, "--trg-dumpdir", trg, "--use-teacher-forcing",
                    "--checkpoint", ckpt, "--outdir", str(out), "--device", "cpu"])
    got = _scp_arrays(str(out / "feats.scp"))
    port = VTN(**config["model_params"])
    port.load_state_dict(torch.load(ckpt, weights_only=True)["model"])
    port.eval()
    src_a, trg_a = _scp_arrays(src), _scp_arrays(trg)
    forward = jax.jit(lambda p, *args: jax_model.apply(
        p, *args, deterministic=True, rngs={"dropout": jax.random.PRNGKey(0)}))  # prenet rate 0
    for utt in src_a:  # padded as vc_decode pads them
        x, y = _padded([src_a[utt]], vc_decode.BUCKET_FRAMES), trg_a[utt]
        ys = _padded([y], vc_decode.BUCKET_FRAMES)
        labels = (np.arange(ys.shape[1]) >= len(y) - 1).astype(np.float32)[None]
        args = (x, np.array([len(src_a[utt])]), ys, labels, np.array([len(y)]))
        ref = forward(flax, *args)
        with torch.no_grad():
            mine = port(*map(torch.from_numpy, args), need_att_ws=True)
        t_red, s_len = int(ref["olens_in"][0]), int(ref["ilens_ds_st"][0])
        att_ref = np.asarray(ref["att_ws"])[:, 0, :, :t_red, :s_len]
        att = mine["att_ws"][:, 0, :, :t_red, :s_len].numpy()
        np.testing.assert_allclose(att, att_ref, atol=1e-5, rtol=0)
        dur = np.loadtxt(out / "durations" / f"{utt}.txt", dtype=np.int64, ndmin=1)
        np.testing.assert_array_equal(dur, jax_durations(att_ref)[0])
        np.testing.assert_array_equal(dur, calculate_durations(att)[0])
        n = int(ref["olens"][0])
        np.testing.assert_allclose(got[utt], np.asarray(ref["after_outs"])[0, :n], atol=2e-5,
                                   rtol=0)


@pytest.mark.parametrize("batch,match", [("3", "positive multiple"), ("1", "positive multiple"),
                                         ("2", "available devices 1")])
def test_vc_decode_refuses_data_parallel(tmp_path, batch, match):
    # as the JAX driver: a batch size that is not a positive multiple of N,
    # or more ranks than devices (one process: one rank on the CPU)
    with pytest.raises(ValueError, match=match):
        vc_decode.main(["--dumpdir", "x", "--checkpoint", "x", "--outdir", str(tmp_path),
                        "--data-parallel", "2", "--batch-size", batch, "--device", "cpu"])


# --------------------------------------------------------------- vc_train
def _train_args(tmp_path, family, dropout=False):
    """A 4-utterance corpus and the conf of ``family``, with dropout off
    unless ``dropout`` (then at the conf's rates); returns vc_train's
    arguments without --outdir."""
    src = _write_feats(tmp_path / "corpus", "src", [40, 47, 33, 52], seed=4)
    trg = _write_feats(tmp_path / "corpus", "trg", [44, 50, 36, 49], seed=5)
    args = ["--src-train-dumpdir", src, "--src-dev-dumpdir", src, "--trg-train-dumpdir", trg,
            "--trg-dev-dumpdir", trg, "--device", "cpu"]
    if family == "aas_vc":
        off = {} if dropout else dict(postnet_dropout_rate=0.0,
                                      stochastic_duration_predictor_dropout_rate=0.0,
                                      **NO_DROPOUT)
        config = _conf(SYNTH, compute_dtype="float32", **off)
        args += ["--train-dp-input-dir", src, "--dev-dp-input-dir", src]
    else:
        vtn = dict(TINY_VTN, dprenet_dropout_rate=0.5) if dropout else dict(TINY_VTN, **NO_DROPOUT)
        config = _conf(VTN_CONF, **vtn)
        config["inference"] = dict(config["inference"], maxlenratio=1.0)
    config.update(batch_size=2, eval_interval_steps=2, save_interval_steps=2,
                  log_interval_steps=1, num_save_intermediate_results=2)
    conf = tmp_path / "conf.yaml"
    conf.write_text(yaml.safe_dump(config))
    return args + ["--config", str(conf)]


def _steps(tmp_path, n):
    path = tmp_path / f"steps{n}.yaml"
    path.write_text(yaml.safe_dump({"train_max_steps": n}))
    return ["--additional-config", str(path)]


@pytest.mark.parametrize("family,stop,dropout", [
    pytest.param("aas_vc", 2, False, id="aas_vc"),
    pytest.param("vtn", 2, False, id="vtn"),
    # 4 utterances at B 2: step 1 ends mid-epoch, so the resumed loader
    # skips into its epoch; dropout on draws from torch's default generator
    pytest.param("aas_vc", 1, True, id="aas_vc-mid_epoch-dropout"),
    pytest.param("vtn", 1, True, id="vtn-mid_epoch-dropout"),
])
def test_vc_train_resumed_run_equals_a_straight_one(tmp_path, family, stop, dropout):
    args = _train_args(tmp_path, family, dropout)
    first = tmp_path / "first"
    vc_train.main(args + _steps(tmp_path, stop) + ["--outdir", str(first)])
    assert (first / "config.yml").exists() and (first / f"checkpoint-{stop}steps.pt").exists()
    assert load_config(str(first / "config.yml"))["train_max_steps"] == stop
    assert len(list((first / "predictions").glob("*/*.npy"))) == (2 if stop == 2 else 0)
    resumed = vc_train.main(args + _steps(tmp_path, 4) + ["--outdir", str(tmp_path / "resumed"),
                                                         "--resume",
                                                         str(first / f"checkpoint-{stop}steps.pt")])
    straight = vc_train.main(args + _steps(tmp_path, 4) + ["--outdir", str(tmp_path / "straight")])
    assert resumed.steps == straight.steps == 4
    a = torch.load(tmp_path / "resumed" / "checkpoint-4steps.pt", weights_only=True)
    b = torch.load(tmp_path / "straight" / "checkpoint-4steps.pt", weights_only=True)
    assert sorted(a["model"]) == sorted(b["model"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for n in (2, 4):
        assert len(list((tmp_path / "straight" / "predictions" / f"{n}steps").glob("*.npy"))) == 2


def test_vc_train_logs_prng_impl(caplog):
    # the port refuses no option of the JAX driver: prng_impl is accepted,
    # and logged as having no effect in torch (tensor, sequence and pipeline
    # parallelism: tests/test_torch_model_parallel.py)
    with caplog.at_level(logging.INFO):
        vc_train.refuse_unported({"prng_impl": "rbg"})
    assert "prng_impl 'rbg' has no effect" in caplog.text


# --------------------------------------------------------------- vc_serve
class _Recorder:
    """Stands in for the converter: halves the input, records each call."""

    sr = 16000

    def __init__(self):
        self.calls = []

    def __call__(self, audio, generator=None):
        self.calls.append([len(audio)])
        return 0.5 * audio

    def convert_batch(self, audios, generator=None):
        self.calls.append([len(a) for a in audios])
        return [0.5 * a for a in audios]

    def warmup_synth(self):
        return 0


def test_vc_serve_stdio_converts_with_a_checkpoint(tmp_path, monkeypatch):
    torch.manual_seed(0)
    config = _conf(SYNTH, compute_dtype="float32")
    model = AASVC(**config["model_params"])
    exp = tmp_path / "exp"
    exp.mkdir()
    dump_config(config, str(exp), "0.1.0")
    torch.save({"model": model.state_dict()}, exp / "checkpoint-1steps.pt")
    gen = dict(in_channels=80, upsample_channels=16, upsample_factors=[8, 8, 2, 2],
               upsample_kernel_sizes=[16, 16, 4, 4], resblock_kernel_sizes=[3],
               resblock_dilation_sizes=[[1]])
    torch.save(HifiganGenerator(**gen).state_dict(), tmp_path / "voc.pt")
    (tmp_path / "voc.yaml").write_text(yaml.safe_dump({"generator_type": "HifiganGenerator",
                                                       "generator_params": gen}))
    rng = np.random.default_rng(0)
    write_stats(str(tmp_path / "stats.npz"), -4 + rng.random(80), 1 + rng.random(80), "mel")
    audio.write_wav(str(tmp_path / "in.wav"), 0.1 * np.sin(np.arange(12000) * 0.06), 16000)
    audio.write_wav(str(tmp_path / "in8k.wav"), np.zeros(4000, np.float32), 8000)
    lines = [f"{tmp_path}/in.wav {tmp_path}/out.wav", f"{tmp_path}/in8k.wav {tmp_path}/o8.wav",
             "only-one-field", ""]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines) + "\n"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        vc_serve.main(["--checkpoint", str(exp / "checkpoint-1steps.pt"),
                       "--src-stats", str(tmp_path / "stats.npz"),
                       "--trg-stats", str(tmp_path / "stats.npz"),
                       "--vocoder-checkpoint", str(tmp_path / "voc.pt"),
                       "--vocoder-config", str(tmp_path / "voc.yaml"),
                       "--warmup-seconds", "0.2", "--device", "cpu"])
    out = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert out[0] == {"ready": True} and len(out) == 4
    for res, secs in ((out[1], 0.75), (out[2], 0.5)):
        assert res["ok"] and res["batch"] == 1 and res["input_seconds"] == secs
        assert res["wall_ms"] > 0 and res["rtf"] > 0
        wav, sr = audio.read_wav(res["out"])
        assert sr == 16000 and len(wav) == round(res["output_seconds"] * 16000) > 0
        assert len(wav) % 256 == 0
    assert not out[3]["ok"] and "expected" in out[3]["error"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_vc_serve_tcp_micro_batches_and_warms_every_batch_size(tmp_path):
    assert vc_serve.batch_sizes(3) == [2, 3] and vc_serve.batch_sizes(8) == [2, 4, 8]
    assert [vc_serve.padded_batch(n, 6) for n in range(1, 7)] == [1, 2, 4, 4, 6, 6]
    warm = _Recorder()
    vc_serve.ConversionService(warm, 16000, max_batch=3).warmup([0.01])
    assert [len(c) for c in warm.calls] == [1, 2, 3]  # a max_batch of 3 is warmed too

    conv = _Recorder()
    service = vc_serve.ConversionService(conv, 16000, max_batch=3, batch_window_ms=500.0)
    port = _free_port()
    server = threading.Thread(target=vc_serve.serve_tcp,
                              args=(service, "127.0.0.1", port, 1.0), daemon=True)
    with contextlib.redirect_stdout(io.StringIO()):
        server.start()
        for _ in range(100):  # wait for the listener
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1).close()
                break
            except OSError:
                time.sleep(0.05)
        results = {}

        def client(i):
            src = tmp_path / f"in{i}.wav"
            audio.write_wav(str(src), np.full(1600 * (i + 1), 0.1 * (i + 1), np.float32), 16000)
            with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
                s.sendall(f"{src} {tmp_path}/out{i}.wav\n\n".encode())
                results[i] = json.loads(s.makefile().readline())

        clients = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=30)
        server.join(timeout=30)  # the idle watchdog ends the server
    assert not server.is_alive()
    assert sorted(results) == [0, 1, 2] and all(r["ok"] and r["batch"] == 3
                                               for r in results.values())
    # three requests in one window: one dispatch of 3, padded to max_batch 3, not 4
    assert len(conv.calls) == 1 and sorted(conv.calls[0]) == [1600, 3200, 4800]
    for i in range(3):
        y, _ = audio.read_wav(str(tmp_path / f"out{i}.wav"))
        np.testing.assert_allclose(y, 0.05 * (i + 1), atol=2e-4)
