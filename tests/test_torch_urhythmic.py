"""Port: Urhythmic's host code, the HiFi-GAN discriminators and fine-tune,
the dataset and ``urhythmic.cli convert`` (seq2seq_vc_torch/urhythmic,
seq2seq_vc_torch/vocoder/hifigan.py), against the JAX package (and
sklearn for the clustering) on the CPU, from numpy-seeded inputs.

- Host code, equal: ``segment`` and ``cluster_merge``; the Ward clustering
  (``children_`` and ``labels_`` against sklearn's
  ``AgglomerativeClustering`` on (100, 256) codebooks); a segmenter pickle
  written by either package gives the other equal segmentations;
  ``identify``; the rhythm models' fits and transforms (gamma fits to
  rtol 1e-12: the same scipy calls) and both stretchers; ``MelDataset``
  batches.
- The discriminators, on weights carried by ``convert``: the multi-period
  one in float32 (JAX's ``PeriodDiscriminator(dtype=float32)``) to 1e-5
  of the largest magnitude (float32 sums in another order), the
  multi-scale one in bfloat16, as JAX hard-wires it, to 2^-5 of the
  largest score and feature-map magnitude, a few units of bfloat16's
  last place: each of its 8 layers rounds to bfloat16 (2^-8 relative) on
  each side, at other points (torch adds the bias before its one rounding,
  flax after), and a score is a sum of terms larger than itself (measured
  up to 1.7 %). The weight-normed generator in float32 to 1e-5 of the peak.
- Three ``HifiganTrainer`` steps, on three batches, at
  tests/test_urhythmic.py's tiny generator widths (float32) against a
  discriminator of one period and two scales (bfloat16, as in JAX; the
  full one is held above, and its JAX step alone would take ~25 s to
  compile): at each step the mel loss to 1e-5 (float32 on both sides) and
  the other losses to relative 2^-6, two bfloat16 roundings, since the
  scores and feature maps are bfloat16 and the feature-matching sum
  accumulates in bfloat16 as in JAX. Updated parameters after the three
  steps (batches differ, so Adam's moments and betas show from step 2):
  fewer than 1 % of the generator's elements off by more than lr / 100
  and their mean error below lr / 100 (measured 0.33 % and lr / 600;
  betas (0.9, 0.999) give 82 % and lr / 20, no weight decay 74 % and
  lr / 40); fewer than 5 % of the discriminator's off by more than
  lr / 10 (measured 2.6 %: an element whose bfloat16 gradient flips sign
  moves by up to 2 lr the other way at each step).
- The trainer's AdamW on fixed gradients against the JAX trainer's own
  ``optax.adamw``, three updates at lr 1e-2 on parameters of magnitude
  ~10 (so the decoupled decay, 1e-3 an update, is ~250 float32 units in
  the last place), one row of gradients below eps, with optax's schedule
  count and the trainer's ``steps`` at 50000 (rate x 0.951): equal to
  four units in the last place of the largest parameter. The
  learning-rate schedule equals optax's ``exponential_decay`` to 1e-6.
- ``cli convert`` end to end writes ``sum(target durations) * 320``
  samples, equal to the JAX ``UrhythmicFine`` host path driving the same
  vocoder, written as PCM16, to one PCM16 step.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from sklearn.cluster import AgglomerativeClustering as SkAgglomerativeClustering

from _torch_port import release_jax_executables  # noqa: F401 (autouse fixture)
import seq2seq_vc_tpu.vocoder.hifigan as jax_hifigan
from seq2seq_vc_tpu import urhythmic as jax_u
from seq2seq_vc_tpu.urhythmic import dataset as jax_dataset
from seq2seq_vc_tpu.urhythmic import segmenter as jax_segmenter
from seq2seq_vc_tpu.train.state import TrainState
from seq2seq_vc_tpu.urhythmic.vocoder_train import HifiganTrainer as JaxHifiganTrainer
from seq2seq_vc_torch import urhythmic as port_u
from seq2seq_vc_torch.convert import hifigan_discriminator_state_dict, hifigan_state_dict
from seq2seq_vc_torch.urhythmic import cli, dataset, segmenter
from seq2seq_vc_torch.urhythmic.cluster import AgglomerativeClustering
from seq2seq_vc_torch.urhythmic.vocoder_train import HifiganTrainer, learning_rate
from seq2seq_vc_torch.utils.audio import read_wav, write_wav
from seq2seq_vc_torch.vocoder.hifigan import (HifiganDiscriminator, HifiganGenerator,
                                              MultiPeriodDiscriminator, MultiScaleDiscriminator,
                                              load_hifigan_backend)

TINY_GEN = dict(in_channels=16, upsample_channels=32, upsample_kernel_sizes=(20, 16, 4, 4),
                upsample_factors=(10, 8, 2, 2), resblock_kernel_sizes=(3,),
                resblock_dilation_sizes=((1, 3),))
F32_RTOL_OF_PEAK = 1e-5
BF16_RTOL_OF_PEAK = 2.0 ** -5
LOSS_RTOL = 2.0 ** -6
LR = 5e-5


def _log_probs(T, K, seed):
    x = np.random.default_rng(seed).standard_normal((T, K)).astype(np.float32) * 3
    return x - np.log(np.exp(x).sum(1, keepdims=True))


def _codebook(seed):
    return np.random.default_rng(seed).standard_normal((100, 256)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_and_cluster_merge_equal(seed):
    lp = _log_probs(60, 100, seed)
    codes, bounds = port_u.segment(lp, 2.0)
    want_codes, want_bounds = jax_u.segment(lp, 2.0)
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_array_equal(bounds, want_bounds)
    labels = np.random.default_rng(seed).integers(0, 3, 100)
    got = segmenter.cluster_merge(labels, codes[bounds[:-1]], bounds)
    want = jax_segmenter.cluster_merge(labels, codes[bounds[:-1]], bounds)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clustering_equals_sklearn(seed):
    x = _codebook(seed)
    got = AgglomerativeClustering(n_clusters=3).fit(x)
    want = SkAgglomerativeClustering(n_clusters=3).fit(x)
    np.testing.assert_array_equal(got.children_, want.children_)
    np.testing.assert_array_equal(got.labels_, want.labels_)
    assert (got.n_leaves_, got.n_features_in_, got.n_clusters_) == (
        want.n_leaves_, want.n_features_in_, want.n_clusters_)


def _identify_inputs(labels, rng):
    """Utterances of cluster-merged segments whose first cluster overlaps
    silence and second voicing."""
    utts = []
    for _ in range(4):
        segs = rng.permutation(np.unique(labels))
        bounds = np.concatenate([[0], np.cumsum(rng.integers(4, 12, len(segs)))])
        sil = np.zeros(bounds[-1], bool)
        voiced = np.zeros(bounds[-1], bool)
        for c, a, b in zip(segs, bounds[:-1], bounds[1:]):
            sil[a:b] = c == labels[0]
            voiced[a:b] = c == labels[50]
        utts.append((segs, bounds, sil, voiced))
    return utts


def _values(sound_types):
    return {int(k): v.value for k, v in sound_types.items()}


def test_segmenter_pickles_cross_and_segment_equally(tmp_path):
    codebook = _codebook(5)
    jseg = jax_u.Segmenter(num_clusters=3, gamma=2)
    jseg.cluster(codebook)
    pseg = port_u.Segmenter(num_clusters=3, gamma=2)
    pseg.cluster(codebook)
    utts = _identify_inputs(jseg.clustering.labels_, np.random.default_rng(6))
    assert _values(pseg.identify(utts)) == _values(jseg.identify(utts))
    lps = [_log_probs(n, 100, 7 + n) for n in (40, 75)]
    for writer, reader_cls in ((jseg, port_u.Segmenter), (pseg, jax_u.Segmenter)):
        path = tmp_path / "segmenter.pkl"
        path.write_bytes(pickle.dumps(writer.state_dict()))
        reader = reader_cls(num_clusters=3, gamma=2)
        reader.load_state_dict(pickle.loads(path.read_bytes()))
        for lp in lps:
            (got, got_b), (want, want_b) = reader(lp), writer(lp)
            assert [c.value for c in got] == [c.value for c in want]
            assert got_b == want_b
    # the port's pickle holds numpy arrays and ints only: no sklearn in it
    assert b"sklearn" not in pickle.dumps(pseg.state_dict())


def _rhythm_utts(rng, mean_frames, n=40):
    types = [port_u.SONORANT, port_u.OBSTRUENT, port_u.SILENCE]
    utts = []
    for _ in range(n):
        durs = np.maximum(rng.poisson(mean_frames, 4), 1)
        utts.append(([types[i % 3] for i in range(4)], list(np.concatenate([[0],
                                                                           np.cumsum(durs)]))))
    return utts


def _jax_types(utts):
    return [([jax_u.SoundType(c.value) for c in cs], b) for cs, b in utts]


def test_rhythm_models_and_stretchers_equal():
    rng = np.random.default_rng(8)
    src, trg = _rhythm_utts(rng, 6), _rhythm_utts(rng, 12)
    # a degenerate sound type (one duration) and one the target never has
    src.append(([port_u.SoundType.NASAL, port_u.SILENCE], [0, 5, 7]))
    port_rm, jax_rm = port_u.RhythmModelFineGrained(), jax_u.RhythmModelFineGrained()
    port_rm.fit_source(src)
    port_rm.fit_target(trg)
    jax_rm.fit_source(_jax_types(src))
    jax_rm.fit_target(_jax_types(trg))
    got, want = port_rm.state_dict(), jax_rm.state_dict()
    assert got.keys() == want.keys()
    for name in got:
        assert got[name].keys() == want[name].keys()
        for c in got[name]:
            np.testing.assert_allclose(got[name][c], want[name][c], rtol=1e-12)
    clusters = [port_u.SONORANT, port_u.SILENCE, port_u.SoundType.NASAL, port_u.OBSTRUENT,
                port_u.SILENCE]
    bounds = [0, 7, 9, 14, 20, 31]
    durs = port_rm(clusters, bounds)
    assert durs == jax_rm([jax_u.SoundType(c.value) for c in clusters], bounds)
    assert len(durs) == 4  # the 2-frame silence is skipped
    units = np.random.default_rng(9).standard_normal((31, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        port_u.TimeStretcherFineGrained()(units, clusters, bounds, durs),
        jax_u.TimeStretcherFineGrained()(units, [jax_u.SoundType(c.value) for c in clusters],
                                         bounds, durs))
    port_g, jax_g = port_u.RhythmModelGlobal(), jax_u.RhythmModelGlobal()
    for m, conv in ((port_g, lambda u: u), (jax_g, _jax_types)):
        m.fit_source(conv(src))
        m.fit_target(conv(trg))
    assert port_g() == jax_g()
    for ratio in (port_g(), 0.37, 1.9):
        np.testing.assert_array_equal(port_u.TimeStretcherGlobal()(units, ratio),
                                      jax_u.TimeStretcherGlobal()(units, ratio))


def _close(got, want, rtol_of_peak):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol_of_peak * np.abs(want).max())


class _MPD32(jax_hifigan.nn.Module):
    """JAX's multi-period discriminator with float32 period discriminators."""

    @jax_hifigan.nn.compact
    def __call__(self, x):
        return [jax_hifigan.PeriodDiscriminator(p, dtype=jnp.float32, name=f"period_{p}")(x)
                for p in (2, 3, 5, 7, 11)]


def _random_params(module, x, seed):
    """Seeded numpy params in the flax tree's shapes (no init compile):
    weight-norm scales around 1, small biases, unit-normal kernels."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        z = rng.standard_normal(v.shape).astype(np.float32)
        name = str(path[-1].key)
        return 1 + 0.3 * z if name.endswith("scale") else 0.1 * z if name == "bias" else z

    return jax.tree_util.tree_map_with_path(leaf, shapes)


class _JaxSmallDiscriminator(jax_hifigan.nn.Module):
    """JAX's HifiganDiscriminator with one period and two scales."""

    @jax_hifigan.nn.compact
    def __call__(self, x):
        mpd_s, mpd_f = jax_hifigan.MultiPeriodDiscriminator(periods=(2,), name="mpd")(x)
        msd_s, msd_f = jax_hifigan.MultiScaleDiscriminator(n_scales=2, name="msd")(x)
        return mpd_s + msd_s, mpd_f + msd_f


class _SmallDiscriminator(torch.nn.Module):
    """The port's HifiganDiscriminator with one period and two scales."""

    def __init__(self):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator(periods=(2,))
        self.msd = MultiScaleDiscriminator(n_scales=2)

    forward = HifiganDiscriminator.forward


@pytest.fixture(scope="module")
def discriminators():
    """(port discriminator, flax params, a batch of waves): seeded numpy
    params in the flax tree's shapes, the weight-norm scales around 1."""
    x = np.random.default_rng(10).uniform(-0.5, 0.5, (2, 4170)).astype(np.float32)
    params = _random_params(jax_hifigan.HifiganDiscriminator(), x, seed=11)
    port = HifiganDiscriminator()
    port.load_state_dict(hifigan_discriminator_state_dict(params, port))
    return port, params, x


def test_discriminators_match_jax(discriminators):
    port, params, x = discriminators
    with torch.no_grad():
        scores, fmaps = port(torch.from_numpy(x))
        mpd_s, mpd_f = port.mpd(torch.from_numpy(x))
        port32 = HifiganDiscriminator(compute_dtype=torch.float32)
        port32.load_state_dict(port.state_dict())
        mpd32_s, mpd32_f = port32.mpd(torch.from_numpy(x))
    assert len(scores) == len(fmaps) == 8
    assert all(torch.equal(a, b) for a, b in zip(scores[:5], mpd_s))
    # the multi-period discriminator in float32
    want = jax.jit(_MPD32().apply)({"params": params["params"]["mpd"]}, x)
    for s, f, (ws, wf) in zip(mpd32_s, mpd32_f, want):
        _close(s, ws, F32_RTOL_OF_PEAK)
        for a, b in zip(f, wf):
            _close(a, np.moveaxis(np.asarray(b), -1, 1), F32_RTOL_OF_PEAK)
    # the multi-scale one in bfloat16, as JAX hard-wires it
    want_s, want_f = jax.jit(jax_hifigan.MultiScaleDiscriminator().apply)(
        {"params": params["params"]["msd"]}, x)
    for s, f, ws, wf in zip(scores[5:], fmaps[5:], want_s, want_f):
        _close(s, ws, BF16_RTOL_OF_PEAK)
        for a, b in zip(f, wf):
            _close(a, np.moveaxis(np.asarray(b.astype(jnp.float32)), -1, 1), BF16_RTOL_OF_PEAK)


def test_weight_normed_generator_matches_jax():
    units = np.random.default_rng(12).standard_normal((2, 9, 16)).astype(np.float32)
    jax_gen = jax_hifigan.HifiganGenerator(**TINY_GEN, dtype=jnp.float32)
    params = _random_params(jax_gen, units, seed=13)
    port = HifiganGenerator(**TINY_GEN, compute_dtype=torch.float32, weight_norm=True)
    port.load_state_dict(hifigan_state_dict(params, port))
    assert {k.rsplit(".", 1)[1] for k in port.state_dict()} == {"weight_g", "weight_v", "bias"}
    with torch.no_grad():
        got = port(torch.from_numpy(units))
    _close(got, jax.jit(jax_gen.apply)(params, units), F32_RTOL_OF_PEAK)
    # fresh: flax's initial scales (1) and biases (0)
    fresh = HifiganGenerator(**TINY_GEN, weight_norm=True)
    assert all((p == 1).all() if k.endswith("weight_g") else not p.any()
               for k, p in fresh.state_dict().items() if not k.endswith("weight_v"))


def test_trainer_step_matches_jax():
    units = np.random.default_rng(6).standard_normal((2, 13, 16)).astype(np.float32)
    wavs = np.random.default_rng(7).uniform(-0.5, 0.5, (2, 13 * 320)).astype(np.float32)
    jax_gen = jax_hifigan.HifiganGenerator(**TINY_GEN, dtype=jnp.float32)
    jt = JaxHifiganTrainer(generator=jax_gen, discriminator=_JaxSmallDiscriminator())
    g0 = _random_params(jax_gen, units, seed=20)
    d0 = _random_params(jt.discriminator, wavs, seed=21)
    jt.g_state = TrainState.create(g0, jt._tx())
    jt.d_state = TrainState.create(d0, jt._tx())
    gen = HifiganGenerator(**TINY_GEN, compute_dtype=torch.float32, weight_norm=True)
    gen.load_state_dict(hifigan_state_dict(g0, gen))
    disc = _SmallDiscriminator()
    disc.load_state_dict(hifigan_discriminator_state_dict(d0, disc))
    trainer = HifiganTrainer(generator=gen, discriminator=disc, device="cpu")
    for i in range(3):
        units = np.random.default_rng(30 + i).standard_normal((2, 13, 16)).astype(np.float32)
        wavs = np.random.default_rng(40 + i).uniform(-0.5, 0.5, (2, 13 * 320)).astype(np.float32)
        want = jt.train_step(units, wavs)
        got = trainer.train_step(units, wavs)
        np.testing.assert_allclose(got["loss_mel"], want["loss_mel"], rtol=1e-5)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=f"{k}, step {i}")
    assert trainer.steps == 3
    g1, d1 = jax.device_get((jt.g_state.params, jt.d_state.params))
    errs = {}
    for mod, p0, p1, conv in ((gen, g0, g1, hifigan_state_dict),
                              (disc, d0, d1, hifigan_discriminator_state_dict)):
        before, after = conv(p0, mod), conv(p1, mod)
        errs[mod] = torch.cat([((v - before[k]) - (after[k] - before[k])).abs().flatten()
                               for k, v in mod.state_dict().items()])
    assert float((errs[gen] > LR / 100).float().mean()) < 0.01
    assert float(errs[gen].mean()) < LR / 100
    assert float((errs[disc] > LR / 10).float().mean()) < 0.05
    schedule = optax.exponential_decay(LR, transition_steps=1000, decay_rate=0.999)
    for t in (0, 1, 999, 1000, 12345, 50000):
        np.testing.assert_allclose(learning_rate(t), float(schedule(t)), rtol=1e-6)


def test_adamw_updates_match_optax():
    lr, t0 = 1e-2, 50000
    rng = np.random.default_rng(22)
    p0 = (10 * rng.standard_normal((64, 32))).astype(np.float32)
    grads = [(s * rng.standard_normal(p0.shape)).astype(np.float32) for s in (1.0, 0.1, 3.0)]
    for g in grads:
        g[0] *= 1e-9  # below eps
    tx = JaxHifiganTrainer(lr=lr)._tx()
    want = jnp.asarray(p0)
    state = tuple(s._replace(count=jnp.asarray(t0, jnp.int32))
                  if isinstance(s, optax.ScaleByScheduleState) else s for s in tx.init(want))
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, want)
        want = optax.apply_updates(want, updates)
    trainer = HifiganTrainer(generator=HifiganGenerator(**TINY_GEN, weight_norm=True),
                             discriminator=MultiPeriodDiscriminator(periods=(2,)), lr=lr,
                             device="cpu")
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = trainer._optimizer(torch.nn.ParameterList([param]))
    for t, g in enumerate(grads):
        trainer.steps = t0 + t
        trainer._update(opt, (param * torch.from_numpy(g)).sum())
    ulp = float(np.spacing(np.float32(np.abs(p0).max())))
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(want), rtol=0, atol=4 * ulp)


def test_trainer_save_and_load(tmp_path):
    """``load`` restores parameters, optimizer state and steps;
    ``finetune`` takes the parameters only and keeps steps at 0."""
    def make():
        return HifiganTrainer(generator=HifiganGenerator(**TINY_GEN, weight_norm=True),
                              discriminator=MultiPeriodDiscriminator(periods=(2,)), device="cpu")

    units = np.random.default_rng(14).standard_normal((1, 6, 16)).astype(np.float32)
    wavs = np.random.default_rng(15).uniform(-0.5, 0.5, (1, 6 * 320)).astype(np.float32)
    a = make()
    a.train_step(units, wavs)
    a.save(str(tmp_path / "model-1.ckpt"))
    for finetune in (False, True):
        b = make()
        b.load(str(tmp_path / "model-1.ckpt"), finetune=finetune)
        assert b.steps == (0 if finetune else 1)
        for k, v in a.generator.state_dict().items():
            assert torch.equal(b.generator.state_dict()[k], v), k
        assert bool(b.g_opt.state) != finetune


def _write_corpus(root, n, seed, sr=16000):
    rng = np.random.default_rng(seed)
    (root / "wav").mkdir()
    (root / "units").mkdir()
    for i in range(n):
        frames = int(rng.integers(10, 40))
        write_wav(str(root / "wav" / f"u{i}.wav"),
                  (0.3 * rng.uniform(-1, 1, frames * 320 + 37)).astype(np.float32), sr)
        np.save(root / "units" / f"u{i}.npy", rng.standard_normal((frames, 8)).astype(np.float32))


def test_mel_dataset_batches_equal(tmp_path):
    _write_corpus(tmp_path, 5, 16)
    args = (str(tmp_path / "wav"), str(tmp_path / "units"))
    port = dataset.MelDataset(*args, segment_length=6400, seed=3)
    ref = jax_dataset.MelDataset(*args, segment_length=6400, seed=3)
    assert len(port) == len(ref) == 5
    for _ in range(2):
        got, want = list(port.batches(2)), list(ref.batches(2))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for k in ("units", "wav"):
                np.testing.assert_array_equal(g[k], w[k])


def test_convert_cli_end_to_end(tmp_path):
    rng = np.random.default_rng(17)
    enc = tmp_path / "enc"
    (enc / "soft").mkdir(parents=True)
    (enc / "logprobs").mkdir()
    for i, n in enumerate((45, 80)):
        np.save(enc / "soft" / f"u{i}.npy", rng.standard_normal((n, 16)).astype(np.float32))
        np.save(enc / "logprobs" / f"u{i}.npy", _log_probs(n, 100, 20 + i))
    seg = port_u.Segmenter(num_clusters=3, gamma=2)
    seg.cluster(_codebook(18))
    seg.sound_types = {0: port_u.SILENCE, 1: port_u.SONORANT, 2: port_u.OBSTRUENT}
    (tmp_path / "segmenter.pkl").write_bytes(pickle.dumps(seg.state_dict()))
    rm = port_u.RhythmModelFineGrained()
    rm.fit_source(_rhythm_utts(rng, 6))
    rm.fit_target(_rhythm_utts(rng, 9))
    (tmp_path / "rhythm.pkl").write_bytes(pickle.dumps(rm.state_dict()))
    torch.manual_seed(19)
    gen = HifiganGenerator(**TINY_GEN, weight_norm=True)
    torch.save({"model": {"generator": gen.state_dict()}, "steps": 0}, tmp_path / "voc.ckpt")
    (tmp_path / "voc.yaml").write_text(yaml.safe_dump({"generator_params": {
        k: list(v) if isinstance(v, tuple) else v for k, v in TINY_GEN.items()}}))
    cli.main(["convert", "--in-dir", str(enc), "--out-dir", str(tmp_path / "out"),
              "--segmenter-checkpoint", str(tmp_path / "segmenter.pkl"),
              "--rhythm-model-checkpoint", str(tmp_path / "rhythm.pkl"),
              "--vocoder-checkpoint", str(tmp_path / "voc.ckpt"),
              "--vocoder-config", str(tmp_path / "voc.yaml"), "--device", "cpu"])
    vocoder = load_hifigan_backend(str(tmp_path / "voc.ckpt"), str(tmp_path / "voc.yaml"), "cpu")
    jseg = jax_u.Segmenter(num_clusters=3, gamma=2)
    jseg.load_state_dict(pickle.loads((tmp_path / "segmenter.pkl").read_bytes()))
    jrm = jax_u.RhythmModelFineGrained()
    jrm.load_state_dict(pickle.loads((tmp_path / "rhythm.pkl").read_bytes()))
    system = jax_u.UrhythmicFine(jseg, jrm, jax_u.TimeStretcherFineGrained(), vocoder)
    for i in range(2):
        units = np.load(enc / "soft" / f"u{i}.npy")
        log_probs = np.load(enc / "logprobs" / f"u{i}.npy")
        got, sr = read_wav(str(tmp_path / "out" / f"u{i}.wav"))
        assert sr == 16000 and np.isfinite(got).all()
        clusters, bounds = jseg(log_probs)
        assert len(got) == sum(jrm(clusters, bounds)) * 320
        want = (np.clip(system(units, log_probs), -1, 1) * 32767).astype(np.int16) / 32768
        np.testing.assert_allclose(got, want, rtol=0, atol=1.0 / 32768)
