"""Port: feature extraction (seq2seq_vc_torch: ``bin/preprocess.py``,
``bin/compute_statistics.py``, ``bin/normalize.py``, ``dsp/features
.LogMelExtractor``, ``dsp/stats.RunningStats``, ``nn/conformer
.ConvBatchNorm``, ``encoders/ppg.py``, ``encoders/encodec.py`` and
``vocoder/encodec_dec.py``) against the JAX package on the CPU, on the
same seeded numpy inputs and the same checkpoint files.

- The CLIs: the JAX ``preprocess`` (HDF5), ``compute_statistics`` and
  ``normalize`` against the port's in both formats (``hdf5`` and ``npy``)
  on three short wavs: a stereo one at 22.05 kHz and one with silent
  edges, under ``trim_silence``, and one cut out of a recording by a kaldi
  ``segments`` file; log-mel and a tiny ``ppg_sxliu``. The wave is equal;
  the log-mel within 1e-4 (log10 of float32 sums in another order), the
  PPG within 1e-5 of its largest magnitude (float32 through a conformer;
  seeded weights give values near 100); the statistics as the features
  they come from, and equal to float64 numpy on the port's own features
  within 1e-6 relative; the normalised features within 1e-3 of JAX's
  (1e-4 over a scale of ~0.3) and equal to ``(x - mean) / scale`` on the
  port's own arrays.
- The conformer's batch-norm conv module, eval and train mode, against
  flax ``nn.BatchNorm`` inside the JAX ``ConvolutionModule``: output and
  the updated running mean and variance within 1e-5.
- The PPG extractor (adim 32, 2 blocks, an 80-bin fbank, BN statistics
  away from 0 and 1, keys under ``model.``) against JAX ``build_extractor``
  at two lengths, as in the CLIs; ``infer_architecture`` equal.
- EnCodec at full width: the encoder in HF and facebookresearch naming
  (weight norm folded), at 2363 samples (not a multiple of 320), unpadded
  and padded as ``preprocess`` pads it, and the decoder, against
  ``convert_torch_encodec{,_decoder}``; ``get_vocoder``'s ``encodec`` route
  against the JAX one. Within 1e-4 of the output's largest magnitude
  (float32 through 15 layers and an LSTM).
- The refusals, as the JAX CLI's: a ``hubert`` entry without
  ``checkpoint`` (its features are held in tests/test_torch_hubert.py), a
  ``ppg_sxliu`` without ``upstream_checkpoint`` and an unknown type.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_port import release_jax_executables  # noqa: F401 (autouse fixture)
from seq2seq_vc_tpu.bin import compute_statistics as jax_compute_statistics
from seq2seq_vc_tpu.bin import normalize as jax_normalize
from seq2seq_vc_tpu.bin import preprocess as jax_preprocess
from seq2seq_vc_tpu.convert.reference import _bn, _conv1d, _StateDict
from seq2seq_vc_tpu.encoders import encodec as jax_encodec
from seq2seq_vc_tpu.encoders import ppg as jax_ppg
from seq2seq_vc_tpu.nn.conformer import ConvolutionModule as JaxConvolutionModule
from seq2seq_vc_tpu.utils.io import read_hdf5
from seq2seq_vc_tpu.vocoder.vocoder import get_vocoder as jax_get_vocoder
from seq2seq_vc_torch.bin import compute_statistics, normalize, preprocess
from seq2seq_vc_torch.encoders import encodec, ppg
from seq2seq_vc_torch.nn.conformer import ConvolutionModule
from seq2seq_vc_torch.utils.audio import write_wav
from seq2seq_vc_torch.utils.io import read_stats
from seq2seq_vc_torch.vocoder.vocoder import get_vocoder

MEL_ATOL = 1e-4  # as the docstring says
PPG_RTOL_OF_PEAK = 1e-5
NORM_ATOL = 1e-3
BN_ATOL = 1e-5
ENCODEC_RTOL_OF_PEAK = 1e-4
CONF = dict(sampling_rate=16000, fft_size=512, hop_size=128, win_length=None, window="hann",
            num_mels=20, fmin=80, fmax=7600, global_gain_scale=1.0, trim_threshold_in_db=30,
            trim_frame_size=1024, trim_hop_size=256)
TINY_PPG = dict(input_dim=80, adim=32, aheads=4, eunits=64, elayers=2, cnn_module_kernel=7)


def _perturb(module: torch.nn.Module, seed: int) -> None:
    """Every float tensor of ``module`` moved off its init; batch-norm
    running variances kept positive."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if t.dtype.is_floating_point:
                noise = 0.1 * torch.randn(t.shape, generator=g)
                t.copy_(t.abs() + 0.5 + noise.abs() if name.endswith("running_var")
                        else t + noise)


def _ppg_checkpoints(root: Path, seed: int = 0):
    """A tiny espnet-named upstream (under ``model.``, with a CTC head the
    loader drops) and an s3prl-vc featurizer, as torch files."""
    torch.manual_seed(seed)
    up = ppg.PPGUpstream(**TINY_PPG, device="cpu")
    _perturb(up, seed)
    sd = {f"model.{k}": v for k, v in up.state_dict().items()}
    sd["model.ctc.ctc_lo.weight"] = torch.randn(10, 32)
    torch.save(sd, root / "upstream.pt")
    weights = torch.randn(TINY_PPG["elayers"] + 1, generator=torch.Generator().manual_seed(seed))
    torch.save({"featurizer": {"weights": weights}, "steps": 0}, root / "downstream.pkl")
    return str(root / "upstream.pt"), str(root / "downstream.pkl")


def _clip(seconds, sr, seed, edges=0.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    y = 0.3 * np.sin(2 * np.pi * 180 * t * (1 + 0.2 * t)) + 0.02 * rng.standard_normal(len(t))
    if edges:
        y[: int(edges * sr)] = 1e-4 * rng.standard_normal(int(edges * sr))
        y[-int(edges * sr):] = 0.0
    return y.astype(np.float32)


def _close_feat(got, want, feat: str, peak=None):
    """Within the docstring's tolerance of ``feat``: absolute for the
    log-mel, of the largest magnitude (of ``peak`` where given) for PPG."""
    assert got.shape == want.shape
    atol = MEL_ATOL if feat == "mel" else PPG_RTOL_OF_PEAK * np.abs(
        want if peak is None else peak).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _run_jax(main, argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("S2S_JAX_CACHE_DIR", "")  # no persistent compilation cache
        mp.setattr(sys, "argv", ["prog"] + argv)
        main()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The wavs, the confs and the JAX CLIs' dumps: run A (``trim_silence``)
    over the stereo 22.05 kHz wav and the one with silent edges, run B over
    two utterances cut from one recording by ``segments``."""
    root = tmp_path_factory.mktemp("features")
    up, down = _ppg_checkpoints(root)
    stereo = np.stack([_clip(0.9, 22050, 1), _clip(0.9, 22050, 2)], axis=1)
    write_wav(str(root / "stereo.wav"), stereo, 22050)
    write_wav(str(root / "edges.wav"), _clip(1.2, 16000, 3, edges=0.25), 16000)
    write_wav(str(root / "rec.wav"), _clip(2.0, 16000, 4), 16000)
    (root / "a.scp").write_text(f"stereo {root / 'stereo.wav'}\nedges {root / 'edges.wav'}\n")
    (root / "b.scp").write_text(f"rec1 {root / 'rec.wav'}\n")
    (root / "segments").write_text("seg1 rec1 0.10 0.83\nseg2 rec1 1.05 1.90\nlost nope 0 1\n")
    feat_list = {"mel": {}, "ppg_sxliu": {"checkpoint": down, "upstream_checkpoint": up,
                                          "input_dim": 80}}
    confs = {}
    for fmt in ("hdf5", "npy"):
        for run, trim in (("a", True), ("b", False)):
            conf = dict(CONF, trim_silence=trim, format=fmt, feat_list=feat_list)
            confs[fmt, run] = root / f"{run}_{fmt}.yaml"
            confs[fmt, run].write_text(yaml.safe_dump(conf))
    jax_dir = root / "jax"
    _run_jax(jax_preprocess.main, ["--wav-scp", str(root / "a.scp"), "--dumpdir",
                                   str(jax_dir / "a"), "--config", str(confs["hdf5", "a"])])
    _run_jax(jax_preprocess.main, ["--wav-scp", str(root / "b.scp"), "--segments",
                                   str(root / "segments"), "--dumpdir", str(jax_dir / "b"),
                                   "--config", str(confs["hdf5", "b"])])
    for feat in ("mel", "ppg_sxliu"):
        _run_jax(jax_compute_statistics.main, ["--rootdir", str(jax_dir / "a"), "--config",
                                               str(confs["hdf5", "a"]), "--dumpdir",
                                               str(jax_dir / f"stats_{feat}"),
                                               "--feat_type", feat])
        for run in ("a", "b"):
            _run_jax(jax_normalize.main, ["--rootdir", str(jax_dir / run), "--dumpdir",
                                          str(jax_dir / f"norm_{feat}_{run}"), "--stats",
                                          str(jax_dir / f"stats_{feat}" / "stats.h5"),
                                          "--feat_type", feat])
    return root, confs


def _read(dump: Path, fmt: str, utt: str, name: str) -> np.ndarray:
    if fmt == "hdf5":
        return read_hdf5(str(dump / f"{utt}.h5"), name)
    scp = dict(line.split() for line in (dump / f"{name}.scp").read_text().splitlines())
    assert scp[utt] == str(dump / name / f"{utt}.npy")
    return np.load(scp[utt])


@pytest.mark.parametrize("fmt", ["hdf5", "npy"])
def test_clis_match_the_jax_clis(corpus, fmt):
    root, confs = corpus
    jax_dir, out = root / "jax", root / fmt
    cpu = ["--device", "cpu"]
    preprocess.main(["--wav-scp", str(root / "a.scp"), "--dumpdir", str(out / "a"),
                     "--config", str(confs[fmt, "a"])] + cpu)
    r = preprocess.main(["--wav-scp", str(root / "b.scp"), "--segments", str(root / "segments"),
                         "--dumpdir", str(out / "b"), "--config", str(confs[fmt, "b"])] + cpu)
    assert r["utterances"] == 2 and set(r["seconds"]) == {"mel", "ppg_sxliu"}
    utts = {"a": ("stereo", "edges"), "b": ("seg1", "seg2")}
    for run, names in utts.items():
        for utt in names:
            wave = _read(out / run, fmt, utt, "wave")
            np.testing.assert_array_equal(wave, read_hdf5(str(jax_dir / run / f"{utt}.h5"),
                                                          "wave"))
            mel = _read(out / run, fmt, utt, "mel")
            assert len(wave) == len(mel) * CONF["hop_size"]
            for feat in ("mel", "ppg_sxliu"):
                want = read_hdf5(str(jax_dir / run / f"{utt}.h5"), feat)
                got = _read(out / run, fmt, utt, feat)
                assert got.dtype == np.float32
                _close_feat(got, want, feat)
    # the edges were trimmed, the stereo wav resampled and its channels averaged
    assert len(_read(out / "a", fmt, "edges", "wave")) < 0.9 * 16000  # of 1.2 s

    for feat in ("mel", "ppg_sxliu"):
        r = compute_statistics.main(["--rootdir", str(out / "a"), "--config",
                                     str(confs[fmt, "a"]), "--dumpdir",
                                     str(out / f"stats_{feat}"), "--feat_type", feat] + cpu)
        assert r["path"].endswith("stats.npz" if fmt == "npy" else "stats.h5")
        got = read_stats(r["path"], feat)
        want = read_stats(str(jax_dir / f"stats_{feat}" / "stats.h5"), feat)
        own = np.concatenate([_read(out / "a", fmt, u, feat) for u in utts["a"]]).astype(
            np.float64)
        for key, ref in (("mean", own.mean(0)), ("scale", own.std(0))):
            _close_feat(got[key], want[key], feat, peak=own)
            np.testing.assert_allclose(got[key], ref, rtol=1e-6, atol=0)
        for run, names in utts.items():
            normalize.main(["--rootdir", str(out / run), "--dumpdir",
                            str(out / f"norm_{feat}_{run}"), "--stats", r["path"],
                            "--feat_type", feat, "--config", str(confs[fmt, run])] + cpu)
            for utt in names:
                got = _read(out / f"norm_{feat}_{run}", fmt, utt, feat)
                want = read_hdf5(str(jax_dir / f"norm_{feat}_{run}" / f"{utt}.h5"), feat)
                np.testing.assert_allclose(got, want, rtol=0, atol=NORM_ATOL)
                x = _read(out / run, fmt, utt, feat)
                np.testing.assert_array_equal(got, (x - r["mean"]) / r["scale"])
                np.testing.assert_array_equal(_read(out / f"norm_{feat}_{run}", fmt, utt,
                                                    "wave"), _read(out / run, fmt, utt, "wave"))


def test_npy_scps_read_from_another_directory(corpus, tmp_path, monkeypatch):
    """A relative ``--dumpdir`` (``dump/train/raw``, as in the README): the
    scps hold absolute paths, so the next CLI reads them from anywhere."""
    root, _ = corpus
    (tmp_path / "conf.yaml").write_text(yaml.safe_dump(dict(CONF, format="npy")))
    monkeypatch.chdir(tmp_path)
    preprocess.main(["--wav-scp", str(root / "b.scp"), "--segments", str(root / "segments"),
                     "--dumpdir", "dump/train/raw", "--config", "conf.yaml", "--device", "cpu"])
    dump = tmp_path / "dump" / "train" / "raw"
    (tmp_path / "elsewhere").mkdir()
    monkeypatch.chdir(tmp_path / "elsewhere")
    for name in ("wave", "mel"):
        scp = dict(line.split() for line in (dump / f"{name}.scp").read_text().splitlines())
        assert scp == {utt: str(dump / name / f"{utt}.npy") for utt in ("seg1", "seg2")}
    r = compute_statistics.main(["--rootdir", str(dump), "--config", str(tmp_path / "conf.yaml"),
                                 "--dumpdir", str(tmp_path / "stats"), "--feat_type", "mel",
                                 "--device", "cpu"])
    assert r["utterances"] == 2


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_batch_norm_conv_module_matches_flax(train):
    C, B, T = 8, 3, 11
    torch.manual_seed(1)
    port = ConvolutionModule(C, 5, conv_norm_type="batch_norm")
    _perturb(port, 1)
    port.train(train)
    sd = _StateDict({f"m.{k}": v for k, v in port.state_dict().items()})
    params = {f"Conv_{i}": _conv1d(sd, f"m.{name}") for i, name in
              enumerate(("pointwise_conv1", "depthwise_conv", "pointwise_conv2"))}
    params["BatchNorm_0"], stats = _bn(sd, "m.norm")
    sd.finish()
    rng = np.random.default_rng(2)
    # standard deviation 4: the batch variance of the depthwise output stays
    # well above its mean's square, where flax's one-pass variance would
    # cancel digits on both sides
    x = (4 * rng.standard_normal((B, T, C)) + 0.5).astype(np.float32)
    mask = np.arange(T)[None] < np.array([[T], [7], [4]])
    jax_mod = JaxConvolutionModule(C, 5, "batch_norm")
    variables = {"params": params, "batch_stats": {"BatchNorm_0": stats}}
    want, updated = jax_mod.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                                  deterministic=not train, mutable=["batch_stats"])
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=BN_ATOL)
    new = updated["batch_stats"]["BatchNorm_0"]
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(port.norm, name).numpy(), np.asarray(new[key]),
                                   rtol=0, atol=BN_ATOL)
        if train:  # the statistics moved
            assert not np.allclose(np.asarray(new[key]), np.asarray(stats[key]))


@pytest.mark.parametrize("n_samples", [8000, 12345])
def test_ppg_extractor_matches_jax(tmp_path, n_samples):
    up, down = _ppg_checkpoints(tmp_path, seed=5)
    sd = ppg._strip_prefix(torch.load(up, weights_only=True))
    assert ppg.infer_architecture(sd) == jax_ppg.infer_architecture(sd)
    assert ppg.infer_architecture(sd)["input_dim"] == 79  # 4 * f2 + 3, where 80 was built
    wav = _clip(n_samples / 16000, 16000, 6)
    got = ppg.build_extractor(up, down, input_dim=80, device="cpu")(wav)
    want = np.asarray(jax_ppg.build_extractor(up, down, input_dim=80)(wav))
    # 1 + n // 160 fbank frames, then the conv2d input layer's x4
    assert got.shape == want.shape == ((((1 + n_samples // 160) - 1) // 2 - 1) // 2, 32)
    _close_feat(got, want, "ppg_sxliu")


def _encodec_checkpoint(path: Path, naming: str, seed: int = 7) -> str:
    """A seeded EnCodec state dict at the module's widths, encoder and
    decoder, every conv weight-normed, in HF names (``layers.N.conv
    .parametrizations.weight.original{0,1}``) or facebookresearch ones
    (``model.N.conv.conv.weight_{g,v}``, ``model.N.convtr.convtr...``)."""
    torch.manual_seed(seed)
    out = {"quantizer.layers.0.codebook.embed": torch.randn(4, 128)}  # not read
    for part, module in (("encoder", encodec.EncodecEncoder()),
                         ("decoder", encodec.EncodecDecoder())):
        _perturb(module, seed)
        mods = dict(module.named_modules())
        for key, w in module.state_dict().items():
            mod, _, leaf = key.rpartition(".")
            conv = isinstance(mods[mod], (torch.nn.Conv1d, torch.nn.ConvTranspose1d))
            name = mod
            if naming == "facebookresearch":
                if conv:
                    inner = "convtr" if isinstance(mods[mod], torch.nn.ConvTranspose1d) else "conv"
                    name = f"{mod.rpartition('.')[0]}.{inner}.{inner}"
                name = "model." + name[len("layers."):]
            if conv and leaf == "weight":
                g = w.flatten(1).norm(dim=1).reshape(-1, 1, 1) * 1.5
                g_key, v_key = (("parametrizations.weight.original0",
                                 "parametrizations.weight.original1") if naming == "hf"
                                else ("weight_g", "weight_v"))
                out[f"{part}.{name}.{g_key}"], out[f"{part}.{name}.{v_key}"] = g, w
            else:
                out[f"{part}.{name}.{leaf}"] = w
    torch.save(out, path)
    return str(path)


def _close_of_peak(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ENCODEC_RTOL_OF_PEAK * np.abs(want).max())


@pytest.mark.parametrize("naming", ["hf", "facebookresearch"])
def test_encodec_matches_jax(tmp_path, naming):
    ckpt = _encodec_checkpoint(tmp_path / "encodec.pt", naming)
    sd = torch.load(ckpt, weights_only=True)
    enc = encodec.load_encodec(ckpt, device="cpu")
    wav = _clip(2363 / 24000, 24000, 8)
    jax_params = jax_encodec.convert_torch_encodec(sd)
    with torch.no_grad():
        got = enc(torch.from_numpy(wav)[None])[0].numpy()
    want = np.asarray(jax_encodec.EncodecEncoder().apply(jax_params, jnp.asarray(wav)[None])[0])
    assert got.shape == (-(-2363 // 320), 128)
    _close_of_peak(got, want)
    # as preprocess extracts them: padded to the 5120-sample bucket, trimmed
    padded = np.pad(wav, (0, -len(wav) % encodec.ENCODE_BUCKET))
    want = np.asarray(jax_encodec.EncodecEncoder().apply(jax_params, padded[None])[0, :8])
    _close_of_peak(encodec.encode(enc, wav).numpy(), want)

    dec = encodec.load_encodec_decoder(ckpt, device="cpu")
    emb = np.random.default_rng(9).standard_normal((1, 10, 128)).astype(np.float32)
    with torch.no_grad():
        got = dec(torch.from_numpy(emb))[0].numpy()
    want = jax_encodec.EncodecDecoder().apply(jax_encodec.convert_torch_encodec_decoder(sd),
                                              jnp.asarray(emb))
    assert got.shape == (3200,)
    _close_of_peak(got, np.asarray(want)[0])


def test_get_vocoder_routes_encodec(tmp_path):
    ckpt = _encodec_checkpoint(tmp_path / "encodec.pt", "hf")
    trg = {"mean": np.full(128, 0.2, np.float32), "scale": np.full(128, 1.5, np.float32)}
    config = {"sampling_rate": 16000, "vocoder": {"vocoder_type": "encodec", "checkpoint": ckpt}}
    voc = get_vocoder(config, trg, device="cpu")
    latents = np.random.default_rng(10).standard_normal((23, 128)).astype(np.float32)
    got = voc.decode(latents)
    want = np.asarray(jax_get_vocoder(config, trg).decode(latents))
    assert voc.fs == 24000 and got.shape == (23 * 320,)
    _close_of_peak(got, want)


@pytest.mark.parametrize("feat_list, error, match", [
    ({"mel": {}, "hubert": {}}, ValueError, "feat_list.hubert needs `checkpoint:`"),
    ({"ppg_sxliu": {"checkpoint": "x"}}, ValueError, "upstream_checkpoint"),
    ({"mel": {}, "whisper": {}}, NotImplementedError, "whisper"),
], ids=["hubert", "ppg_without_upstream", "unknown"])
def test_preprocess_refusals(tmp_path, feat_list, error, match):
    (tmp_path / "conf.yaml").write_text(yaml.safe_dump(dict(CONF, feat_list=feat_list)))
    (tmp_path / "wav.scp").write_text("")
    with pytest.raises(error, match=match):
        preprocess.main(["--wav-scp", str(tmp_path / "wav.scp"), "--dumpdir",
                         str(tmp_path / "dump"), "--config", str(tmp_path / "conf.yaml"),
                         "--device", "cpu"])
