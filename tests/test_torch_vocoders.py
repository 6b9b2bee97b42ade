"""Port: the vocoders other than HiFi-GAN and Griffin-Lim
(seq2seq_vc_torch/vocoder: ``common.py``, ``pwg.py``, ``melgan.py``,
``taco2ar.py``, ``s3prl_feat2wav.py`` and ``vocoder.get_vocoder``'s
routing) and ``bin/vocoder_anasyn_debug.py``, against the JAX package on
the CPU.

- Generators: tiny ParallelWaveGAN, MelGAN and StyleMelGAN written as
  ``parallel_wavegan`` checkpoints (``{"model": {"generator": sd}}``, every
  conv weight-normed: ``weight_g``, ``weight_v``) and read back by the
  port's loaders; the JAX converters fill the flax templates from the
  port's ``state_dict()``. Both run in float32 with the same numpy noise:
  the waveforms agree to 1e-5 of their largest magnitude (float32 sums in
  another order through 6 layers; measured ~3e-7).
- Taco2-AR, both norm types, prenet dropout 0: the mel agrees to 1e-5 of
  its largest magnitude (measured ~6e-7 over 20 AR steps). The prenet's
  always-on dropout: masks of 0 and 1 / keep that repeat with the seed.
- ``get_vocoder``: the port's and the JAX package's ``decode`` on the same
  files, both in float32, agree to 1e-5 of the largest magnitude for
  MelGAN (no noise) and for ``s3prl_vc`` with a MelGAN inner vocoder at
  prenet rate 0; ParallelWaveGAN and StyleMelGAN give finite waveforms of
  T * hop samples that repeat with the seed; an ``encodec`` block without
  a checkpoint raises, naming the key (the route itself is held against
  JAX in tests/test_torch_features.py).
- CLIs: ``vocoder_anasyn_debug`` and ``vc_decode`` (a PWG ``vocoder:``
  block on the tiny VTN; the s3prl-vc vocoder on a tiny VTN whose target
  is a 12-wide PPG, ``--feat-type ppg_sxliu``) write wavs of the right
  length.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_port import TINY_VTN, release_jax_executables  # noqa: F401 (autouse fixture)
from seq2seq_vc_tpu.vocoder import melgan as jax_melgan
from seq2seq_vc_tpu.vocoder import pwg as jax_pwg
from seq2seq_vc_tpu.vocoder import taco2ar as jax_taco2ar
from seq2seq_vc_tpu.vocoder.convert_torch import _effective_weight
from seq2seq_vc_tpu.vocoder.vocoder import get_vocoder as jax_get_vocoder
from seq2seq_vc_torch.bin import vc_decode, vocoder_anasyn_debug
from seq2seq_vc_torch.models.vtn import VTN
from seq2seq_vc_torch.utils.audio import read_wav, write_wav
from seq2seq_vc_torch.utils.io import write_stats
from seq2seq_vc_torch.vocoder import melgan, pwg, taco2ar
from seq2seq_vc_torch.vocoder.common import fold_weight_norm, read_generator_state
from seq2seq_vc_torch.vocoder.vocoder import get_vocoder

REPO = Path(__file__).resolve().parents[1]
VTN_CONF = REPO / "egs/arctic/vc1/conf/vtn.v1.yaml"
RTOL_OF_PEAK = 1e-5  # float32 on both sides, as the docstring says

PWG = dict(layers=6, stacks=2, residual_channels=16, gate_channels=32, skip_channels=16,
           aux_channels=20, upsample_scales=(4, 4))
MELGAN = dict(in_channels=20, out_channels=1, kernel_size=5, channels=32,
              upsample_scales=(4, 3), stack_kernel_size=3, stacks=2)
STYLE = dict(in_channels=8, aux_channels=20, channels=16, out_channels=1, kernel_size=5,
             dilation=2, noise_upsample_scales=(5, 2), upsample_scales=(2, 2, 1))
# per generator: its generator_type, port class, JAX class, widths, hop
KINDS = {
    "pwg": ("ParallelWaveGANGenerator", pwg.ParallelWaveGANGenerator,
            jax_pwg.ParallelWaveGANGenerator, PWG, 16),
    "melgan": ("MelGANGenerator", melgan.MelGANGenerator, jax_melgan.MelGANGenerator,
               MELGAN, 12),
    "style": ("StyleMelGANGenerator", melgan.StyleMelGANGenerator,
              jax_melgan.StyleMelGANGenerator, STYLE, 4),
}
TACO2 = dict(input_dim=12, output_dim=20, encoder_conv_layers=2, encoder_conv_chans=16,
             encoder_conv_filts=5, encoder_units=16, decoder_layers=2, decoder_units=24,
             prenet_layers=2, prenet_units=10)


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL_OF_PEAK * np.abs(want).max())


def _perturbed(module, seed: int, scale: float = 0.05):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(scale * torch.randn(p.shape, generator=g))
    return module


def _weight_normed(state, seed: int):
    """Every conv weight as ``parallel_wavegan`` saves it under weight norm:
    ``weight_v`` and a ``weight_g`` of seeded per-row norms (axis 0)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, w in state.items():
        if key.endswith(".weight") and w.ndim >= 3:
            prefix = key[: -len(".weight")]
            g = w.flatten(1).norm(dim=1).reshape((-1,) + (1,) * (w.ndim - 1))
            out[f"{prefix}.weight_g"] = g * torch.from_numpy(
                rng.uniform(0.5, 1.5, g.shape).astype(np.float32))
            out[f"{prefix}.weight_v"] = w.clone()
        else:
            out[key] = w
    return out


def _generator_params(kind, widths):
    params = {k: list(v) if isinstance(v, tuple) else v for k, v in widths.items()}
    if kind == "pwg":  # parallel_wavegan nests PWG's scales
        params["upsample_params"] = {"upsample_scales": params.pop("upsample_scales")}
    return params


def _checkpoint(tmp_path: Path, kind: str, seed: int = 0, **over):
    """A ``parallel_wavegan`` checkpoint and config of a seeded tiny
    generator (``over`` replaces widths); returns their paths."""
    gen_type, cls, _, params, _ = KINDS[kind]
    params = dict(params, **over)
    torch.manual_seed(seed)
    state = _weight_normed(_perturbed(cls(**params), seed + 1).state_dict(), seed + 2)
    ckpt, cfg = tmp_path / f"{kind}.pkl", tmp_path / f"{kind}.yaml"
    torch.save({"model": {"generator": state}, "steps": 10}, ckpt)
    cfg.write_text(yaml.safe_dump({"generator_type": gen_type, "sampling_rate": 16000,
                                   "generator_params": _generator_params(kind, params)}))
    return str(ckpt), str(cfg)


def _port_model(ckpt, cfg, kind):
    load = pwg.load_pwg_model if kind == "pwg" else functools.partial(
        melgan.load_melgan_model, style=kind == "style")
    model = load(ckpt, cfg, device="cpu")
    model.compute_dtype = torch.float32
    return model


# --------------------------------------------------------------- generators
@pytest.mark.parametrize("kind", list(KINDS))
def test_generator_matches_jax_on_carried_weights(tmp_path, kind):
    _, _, jax_cls, params, hop = KINDS[kind]
    port = _port_model(*_checkpoint(tmp_path, kind), kind)
    rng = np.random.default_rng(1)
    T = 12
    c = rng.standard_normal((1, T, 20)).astype(np.float32)
    jax_model = jax_cls(**params, dtype=jnp.float32)
    # the converters fill every parameter, so the template needs only shapes
    template = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(lambda: jax_model.init({"params": jax.random.PRNGKey(0),
                                               "noise": jax.random.PRNGKey(1)}, c)))
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    if kind == "pwg":
        flax = jax_pwg.torch_pwg_to_flax(sd, template)
    elif kind == "melgan":
        flax = jax_melgan.torch_melgan_to_flax(sd, template, params["upsample_scales"],
                                               params["stacks"])
    else:
        flax = jax_melgan.torch_style_melgan_to_flax(
            sd, template, len(params["noise_upsample_scales"]), len(params["upsample_scales"]))
    with torch.no_grad():
        if kind == "melgan":
            got = port(torch.from_numpy(c)).numpy()
            want = jax_model.apply(flax, c)
        else:  # the same noise, in each framework's layout
            frames = T * hop if kind == "pwg" else -(-T // 10)
            z = rng.standard_normal((1, port.in_channels, frames)).astype(np.float32)
            got = port(torch.from_numpy(c), torch.from_numpy(z)).numpy()
            want = jax_model.apply(flax, c, z=z.transpose(0, 2, 1))
    assert got.shape == (1, T * hop)
    _close(got, np.asarray(want))


@pytest.mark.parametrize("kind", list(KINDS))
def test_checkpoint_reader_folds_weight_norm_as_jax(tmp_path, kind):
    ckpt, _ = _checkpoint(tmp_path, kind)
    raw = {k: v.numpy() for k, v in torch.load(ckpt)["model"]["generator"].items()}
    got = read_generator_state(ckpt)
    prefixes = [k[: -len(".weight_v")] for k in raw if k.endswith(".weight_v")]
    assert prefixes and not any(k.endswith(("weight_g", "weight_v")) for k in got)
    for p in prefixes:
        np.testing.assert_allclose(got[f"{p}.weight"].numpy(), _effective_weight(raw, p),
                                   rtol=1e-6, atol=1e-7)
    module_sd = {"module." + k: torch.from_numpy(v) for k, v in raw.items()}
    assert sorted(fold_weight_norm(module_sd)) == sorted("module." + k for k in got)


def test_pwg_reads_parallel_wavegans_conv_in_name(tmp_path):
    ckpt, cfg = _checkpoint(tmp_path, "pwg")
    state = torch.load(ckpt)
    sd = state["model"]["generator"]
    for part in ("g", "v"):
        sd[f"upsample_net.conv_in.weight_{part}"] = sd.pop(f"upsample_net.conv_in.conv.weight_{part}")
    renamed = tmp_path / "renamed.pkl"
    torch.save(state, renamed)
    a, b = (_port_model(p, cfg, "pwg").state_dict() for p in (ckpt, str(renamed)))
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------------- Taco2-AR
def _taco2(norm_type, seed=0, **over):
    torch.manual_seed(seed)
    model = _perturbed(taco2ar.Taco2AR(**dict(TACO2, resample_ratio=1.6, norm_type=norm_type,
                                              **over)).eval(), seed, 0.1)
    if norm_type == "batch_norm":  # running stats away from 0 and 1
        g = torch.Generator().manual_seed(seed + 1)
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(0.3 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
    return model


@pytest.mark.parametrize("norm_type", ["group_norm", "batch_norm"])
def test_taco2ar_matches_jax_on_carried_weights(norm_type):
    port = _taco2(norm_type, prenet_dropout_rate=0.0)
    jax_model = jax_taco2ar.Taco2AR(**TACO2, resample_ratio=1.6, prenet_dropout_rate=0.0,
                                    norm_type=norm_type)
    variables = jax_taco2ar.convert_torch_taco2ar(port.state_dict(), jax_model)
    latents = np.random.default_rng(2).standard_normal((2, 32, 12)).astype(np.float32)
    want = np.asarray(jax_model.apply(variables, jnp.asarray(latents),
                                      rng=jax.random.PRNGKey(0), deterministic=True))
    with torch.no_grad():
        got = port(torch.from_numpy(latents)).numpy()
    assert got.shape == (2, 20, 20)  # round(32 / 1.6) frames
    _close(got, want)


def test_linear_resample_matches_jax():
    x = np.random.default_rng(0).standard_normal((17, 3)).astype(np.float32)
    for n in (11, 17, 29):
        got = taco2ar.linear_resample(torch.from_numpy(x)[None], n)[0].numpy()
        want = np.asarray(jax_taco2ar.linear_resample(jnp.asarray(x), n))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_prenet_dropout_stays_on_and_repeats_with_the_seed():
    rate = 0.5
    masks = taco2ar.prenet_masks(torch.Generator().manual_seed(0), 200, 2, 1, 64, rate)
    assert set(masks.unique().tolist()) == {0.0, 1.0 / (1.0 - rate)}
    assert abs(float((masks == 0).float().mean()) - rate) < 0.02
    again = taco2ar.prenet_masks(torch.Generator().manual_seed(0), 200, 2, 1, 64, rate)
    other = taco2ar.prenet_masks(torch.Generator().manual_seed(1), 200, 2, 1, 64, rate)
    assert torch.equal(masks, again) and not torch.equal(masks, other)
    model = _taco2("group_norm", prenet_dropout_rate=rate)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 16, 12)).astype(np.float32))
    with torch.no_grad():
        outs = [model(x, generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
        model.prenet_dropout_rate = 0.0
        off = model(x)
    assert torch.equal(outs[0], outs[1])
    assert not torch.allclose(outs[0], outs[2]) and not torch.allclose(outs[0], off)


# -------------------------------------------------------------------- routing
@pytest.fixture
def float32_generators(monkeypatch):
    """Both packages' MelGAN loaders build float32 generators."""
    monkeypatch.setattr(jax_melgan, "MelGANGenerator",
                        functools.partial(jax_melgan.MelGANGenerator, dtype=jnp.float32))
    monkeypatch.setattr(melgan, "MelGANGenerator",
                        functools.partial(melgan.MelGANGenerator, compute_dtype=torch.float32))


def _s3prl_config(tmp_path):
    """A downstream Taco2-AR checkpoint (prenet dropout 0), its mel stats
    (HDF5, as the JAX package reads them) and its config, whose own
    ``vocoder:`` block is a MelGAN; returns the VC config's block."""
    ckpt, cfg = _checkpoint(tmp_path, "melgan")
    torch.save({"model": _taco2("group_norm", seed=4).state_dict(), "steps": 10},
               tmp_path / "taco2.pkl")
    rng = np.random.default_rng(6)
    write_stats(str(tmp_path / "ds_stats.h5"), -4 + rng.standard_normal(20),
                1 + 0.5 * rng.random(20))
    ds = {"model_type": "Taco2_AR", "sampling_rate": 16000, "hop_size": 16,
          "upstream_rate": 10, "num_mels": 20,  # 0.625 mel frames a latent
          "model_params": dict({k: v for k, v in TACO2.items()
                                if k not in ("input_dim", "output_dim")},
                               prenet_dropout_rate=0.0),
          "vocoder": {"checkpoint": ckpt, "config": cfg}}
    (tmp_path / "ds.yaml").write_text(yaml.safe_dump(ds))
    return {"vocoder_type": "s3prl_vc", "checkpoint": str(tmp_path / "taco2.pkl"),
            "config": str(tmp_path / "ds.yaml"), "stats": str(tmp_path / "ds_stats.h5")}


def _stats(seed, dim):
    rng = np.random.default_rng(seed)
    return {"mean": (-1 + rng.standard_normal(dim)).astype(np.float32),
            "scale": (1 + 0.5 * rng.random(dim)).astype(np.float32)}


@pytest.mark.usefixtures("float32_generators")
def test_get_vocoder_melgan_and_s3prl_vc_match_jax(tmp_path):
    ckpt, cfg = _checkpoint(tmp_path, "melgan")
    block = {"checkpoint": ckpt, "config": cfg}
    rng = np.random.default_rng(7)
    mel = rng.standard_normal((70, 20)).astype(np.float32)  # past one 64-frame bucket
    trg = _stats(8, 20)
    got = get_vocoder({"vocoder": block}, trg, device="cpu").decode(mel)
    want = jax_get_vocoder({"vocoder": block}, trg).decode(mel)
    assert got.shape == (70 * 12,)
    _close(got, np.asarray(want))

    block = _s3prl_config(tmp_path)
    latents = rng.standard_normal((40, 12)).astype(np.float32)
    trg = _stats(9, 12)
    got = get_vocoder({"vocoder": block}, trg, device="cpu").decode(latents)
    want = jax_get_vocoder({"vocoder": block}, trg).decode(latents)
    assert got.shape == (25 * 12,)  # round(40 * 0.625) mel frames, hop 12
    _close(got, np.asarray(want))


@pytest.mark.parametrize("kind", ["pwg", "style"])
def test_get_vocoder_noise_generators_repeat_with_the_seed(tmp_path, kind):
    ckpt, cfg = _checkpoint(tmp_path, kind)
    voc = get_vocoder({"vocoder": {"checkpoint": ckpt, "config": cfg}}, device="cpu")
    mel = np.random.default_rng(10).standard_normal((23, 20)).astype(np.float32)
    a, b = voc.decode(mel), voc.decode(mel)
    assert a.shape == (23 * KINDS[kind][4],) and np.isfinite(a).all() and np.abs(a).max() > 0
    np.testing.assert_array_equal(a, b)


def test_get_vocoder_refuses_encodec_naming_its_item():
    with pytest.raises(ValueError, match="encodec' needs `checkpoint:`"):
        get_vocoder({"vocoder": {"vocoder_type": "encodec"}}, device="cpu")


# ----------------------------------------------------------------------- CLIs
def test_vocoder_anasyn_debug_resynthesises_each_wav(tmp_path):
    ckpt, cfg = _checkpoint(tmp_path, "melgan")
    config = {"sampling_rate": 16000, "fft_size": 64, "hop_size": 12, "num_mels": 20,
              "fmin": 80, "fmax": 7600, "vocoder": {"checkpoint": ckpt, "config": cfg}}
    (tmp_path / "conf.yaml").write_text(yaml.safe_dump(config))
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    rng = np.random.default_rng(11)
    lens = {"a": 1000, "b": 1234}
    for utt, n in lens.items():
        write_wav(str(wavs / f"{utt}.wav"), 0.3 * rng.standard_normal(n), 16000)
    write_stats(str(tmp_path / "stats.npz"), -3 * np.ones(20), 2 * np.ones(20), "mel")
    out = vocoder_anasyn_debug.main(["--rootdir", str(wavs), "--config",
                                     str(tmp_path / "conf.yaml"), "--outdir",
                                     str(tmp_path / "out"), "--stats",
                                     str(tmp_path / "stats.npz"), "--device", "cpu"])
    assert out["utterances"] == 2
    for utt, n in lens.items():
        y, sr = read_wav(str(tmp_path / "out" / f"{utt}.wav"))
        assert sr == 16000 and len(y) == (1 + n // 12) * 12 and np.abs(y).max() > 0


@pytest.mark.parametrize("target", ["mel_pwg", "ppg_s3prl_vc"])
def test_vc_decode_writes_wavs_through_the_vocoder(tmp_path, target):
    odim, feat = (80, "mel") if target == "mel_pwg" else (12, "ppg_sxliu")
    with open(VTN_CONF) as f:
        config = yaml.safe_load(f)
    config["model_params"] = dict(config["model_params"], **dict(TINY_VTN, odim=odim))
    config["inference"] = dict(config["inference"], threshold=1.1, maxlenratio=1.0)
    if target == "mel_pwg":
        ckpt, cfg = _checkpoint(tmp_path, "pwg", aux_channels=80)
        config["vocoder"], hop = {"checkpoint": ckpt, "config": cfg}, lambda n: n * 16
    else:  # Taco2-AR: round(n / 1.6) mel frames, then MelGAN's hop 12
        config["vocoder"], hop = _s3prl_config(tmp_path), lambda n: round(n / 1.6) * 12
    torch.manual_seed(0)
    exp = tmp_path / "exp"
    exp.mkdir()
    (exp / "config.yml").write_text(yaml.safe_dump(config))
    torch.save({"model": _perturbed(VTN(**config["model_params"]), 2).state_dict()},
               exp / "checkpoint-0steps.pt")
    write_stats(str(tmp_path / "trg_stats.npz"), np.zeros(odim), np.ones(odim), feat)
    rng = np.random.default_rng(12)
    lines = []
    for i, n in enumerate((37, 50)):
        np.save(tmp_path / f"src{i}.npy", (-4 + rng.standard_normal((n, 80))).astype(np.float32))
        lines.append(f"utt{i} {tmp_path / f'src{i}.npy'}")
    (tmp_path / "src.scp").write_text("\n".join(lines) + "\n")
    out = tmp_path / "out"
    vc_decode.main(["--dumpdir", str(tmp_path / "src.scp"), "--checkpoint",
                    str(exp / "checkpoint-0steps.pt"), "--outdir", str(out), "--trg-stats",
                    str(tmp_path / "trg_stats.npz"), "--feat-type", feat, "--device", "cpu"])
    for i in range(2):
        feats = np.load(out / f"utt{i}.npy")
        y, sr = read_wav(str(out / "wav" / f"utt{i}.wav"))
        assert feats.shape[1] == odim and sr == 16000 and len(y) == hop(len(feats))
