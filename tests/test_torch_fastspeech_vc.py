"""Port: FastSpeech-VC (seq2seq_vc_torch/models/fastspeech_vc.py and what it
brought in: nn/duration_predictor.py, losses/duration.DurationPredictorLoss,
ops/upsampling.length_regulator, the conformer's conv2d input layer, the
transformer encoder without an input layer, convert.fastspeech_vc_state_dict,
train/nar_vc.NARVCTrainer, the teacher durations of the dataset and the
collater, and the CLIs on FastSpeech-VC), and AAS-VC with the deterministic
duration predictor, against the JAX package on the CPU.

Two tiny models, built in the port from a seed, perturbed, and carried to
the JAX package by its ``convert_fastspeech_vc``: CONFORMER is
egs/arctic/vc2/conf/fs2_vc.melmelmel.v1.yaml's layout (conformer encoder
with the conv2d input layer and decoder, the conv2d duration-predictor
projection of the source mel, teacher factor 1) at adim 32, TRANSFORMER
is egs/synth/vc1/conf/fs2.synth.yaml's model as it ships (transformer
encoder and decoder, the predictor on the encoder states, teacher factor
2, adim 64); 2+2 layers, 2 heads. The conformer model runs through both port routes, dense (``xla``)
and flash with the gate at 16 frames (the fused and the flash plain
versions on the CPU), against the JAX model's dense attention.

Tolerances (float32): the predictor's log-domain output and the length
regulator atol 1e-6 (the regulator is a gather: exact), the duration loss
rtol 1e-6; forward and inference outputs atol 1e-4, rtol 1e-4, as
tests/test_torch_aas_vc.py holds inference; rounded durations and output
lengths exactly, after asserting that no pre-rounding value exp(h) - 1 lies
within 1e-3 of a rounding boundary (x.5), so the exact check cannot flip.
One trainer step, dropout off: loss terms rtol 1e-5, each gradient within
1e-4 of its tensor's largest magnitude, as tests/test_torch_train.py.
"""

import functools
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from _torch_port import perturb_, release_jax_executables  # noqa: F401 (autouse fixture)
from seq2seq_vc_tpu.convert.reference import convert_aasvc, convert_fastspeech_vc
from seq2seq_vc_tpu.losses import get_criterion as jax_criterion
from seq2seq_vc_tpu.models import AASVC as JaxAASVC
from seq2seq_vc_tpu.models import FastSpeechVC as JaxFastSpeechVC
from seq2seq_vc_tpu.ops.upsampling import length_regulator as jax_length_regulator
from seq2seq_vc_tpu.train.nar_vc import NARVCTrainer as JaxNARVCTrainer
from seq2seq_vc_tpu.train.optim import build_optimizer as jax_build_optimizer
from seq2seq_vc_tpu.train.state import TrainState as JaxTrainState
from seq2seq_vc_torch.bin import vc_decode, vc_train
from seq2seq_vc_torch.convert import aasvc_state_dict, fastspeech_vc_state_dict
from seq2seq_vc_torch.core.config import load_config
from seq2seq_vc_torch.losses import get_criterion
from seq2seq_vc_torch.models.aas_vc import AASVC
from seq2seq_vc_torch.models.common import conv2d_subsampled_lengths
from seq2seq_vc_torch.models.fastspeech_vc import FastSpeechVC
from seq2seq_vc_torch.ops.masks import make_non_pad_mask
from seq2seq_vc_torch.ops.upsampling import length_regulator
from seq2seq_vc_torch.train.aas_vc import AASVCTrainer
from seq2seq_vc_torch.train.nar_vc import NARVCTrainer
from seq2seq_vc_torch.train.optim import build_optimizer
from seq2seq_vc_torch.train.state import TrainState

REPO = Path(__file__).resolve().parents[1]
ARCTIC = REPO / "egs/arctic/vc2/conf/fs2_vc.melmelmel.v1.yaml"
SYNTH = REPO / "egs/synth/vc1/conf/fs2.synth.yaml"
TOL = dict(atol=1e-4, rtol=1e-4)
NO_DROPOUT = {k: 0.0 for k in (
    "transformer_enc_dropout_rate", "transformer_enc_positional_dropout_rate",
    "transformer_enc_attn_dropout_rate", "transformer_dec_dropout_rate",
    "transformer_dec_positional_dropout_rate", "transformer_dec_attn_dropout_rate",
    "duration_predictor_dropout_rate", "postnet_dropout_rate")}
SMALL = dict(adim=32, aheads=2, elayers=2, eunits=64, dlayers=2, dunits=64,
             duration_predictor_chans=16, postnet_layers=2, postnet_chans=16)
CONFORMER = dict(
    load_config(str(ARCTIC))["model_params"], **SMALL, conformer_enc_kernel_size=7,
    conformer_dec_kernel_size=7, attention_backend="xla")
TRANSFORMER = load_config(str(SYNTH))["model_params"]  # its own widths: adim 64
# (name, model config, port keywords): the conformer through both port routes
MODELS = [("conformer-xla", CONFORMER, {}),
          ("conformer-flash", CONFORMER, dict(attention_backend="flash", flash_min_len=16)),
          ("transformer", TRANSFORMER, {})]
B, T_SRC, T_TRG = 2, 64, 64
LENS, OLENS = np.array([64, 50]), np.array([64, 52])
MAX_OUT = 96


def _pair(cfg, port_kw=None, seed=0, model=FastSpeechVC, jax_model=JaxFastSpeechVC,
          convert=convert_fastspeech_vc):
    """(port model in eval mode, JAX model, flax params), weights from the
    port's seeded init (perturbed) carried to flax by the JAX converter."""
    torch.manual_seed(seed)
    port = perturb_(model(**dict(cfg, **(port_kw or {}))).eval(), seed)
    jm = jax_model(**{k: v for k, v in cfg.items() if k != "compute_dtype"})
    return port, jm, convert(port.state_dict(), jm)


def _inputs(seed=0):
    """Source and target features, the source mel as the predictor's input,
    and teacher durations on the encoder grid: item 0 totals under the
    target length, item 1 (3-9 frames a token) over it."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((B, T_SRC, 80)).astype(np.float32)
    ys = rng.standard_normal((B, T_TRG, 80)).astype(np.float32)
    t_enc = int(conv2d_subsampled_lengths(torch.tensor(T_SRC)))
    ds = np.stack([rng.integers(0, 4, t_enc), rng.integers(3, 10, t_enc)]).astype(np.int64)
    return xs, ys, ds


def _assert_off_boundaries(log_d):
    """No exp(h) - 1 within 1e-3 of x.5: round() cannot flip between the
    frameworks' float32 results."""
    x = np.exp(log_d.astype(np.float64)) - 1.0
    assert np.abs(np.abs(x - np.floor(x)) - 0.5).min() > 1e-3, "a duration on a rounding edge"


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@functools.lru_cache(maxsize=None)
def _jax_forward(kind):
    """The JAX model's training forward and inference on ``_inputs()``
    (one per layout: both conformer routes are held to the dense JAX one)."""
    _, jm, flax = _pair(CONFORMER if kind.startswith("conformer") else TRANSFORMER)
    xs, ys, ds = _inputs()
    out = jax.jit(lambda p: jm.apply(p, xs, LENS, ys, OLENS, ds, None, xs, LENS,
                                     deterministic=True))(flax)
    infer = jax.jit(lambda p: jm.apply(p, xs, LENS, xs, max_output_frames=MAX_OUT,
                                       method=JaxFastSpeechVC.inference))(flax)
    return jax.tree_util.tree_map(np.asarray, (out, infer))


# ------------------------------------------------------------------ weights
@pytest.mark.parametrize("cfg", [CONFORMER, TRANSFORMER], ids=["conformer", "transformer"])
def test_weights_round_trip_exactly(cfg):
    port, jm, flax = _pair(cfg)
    back = fastspeech_vc_state_dict(flax, port)
    assert sorted(back) == sorted(port.state_dict())
    for k, v in port.state_dict().items():
        assert torch.equal(back[k], v), k
    xs, ys, ds = _inputs()
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, xs, LENS, ys, OLENS, ds, None, xs, LENS,
        deterministic=True))
    ref = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    got = dict(jax.tree_util.tree_flatten_with_path(flax["params"])[0])
    assert len(ref) == len(got)
    for path, leaf in ref:
        assert got[path].shape == leaf.shape, path


# ------------------------------------------------ predictor, regulator, loss
def test_duration_predictor_matches_jax():
    port, jm, flax = _pair(CONFORMER, seed=1)
    x = np.random.default_rng(1).standard_normal((B, 15, 32)).astype(np.float32)
    pad = ~make_non_pad_mask(torch.tensor([15, 11]), 15)

    def jax_dp(is_inference):
        return np.asarray(jm.apply(flax, x, pad.numpy(), method=lambda m, a, k: (
            m.duration_predictor(a, k, is_inference=is_inference))))

    with torch.no_grad():
        log_d = port.duration_predictor(torch.from_numpy(x), pad)
        d = port.duration_predictor(torch.from_numpy(x), pad, is_inference=True)
    np.testing.assert_allclose(log_d.numpy(), jax_dp(False), atol=1e-6, rtol=0)
    _assert_off_boundaries(log_d.numpy()[~pad.numpy()])
    np.testing.assert_array_equal(d.numpy(), jax_dp(True))
    assert (d.numpy()[pad.numpy()] == 0).all() and (d.numpy() >= 0).all()


@pytest.mark.parametrize("t_feats", [20, 37, 60], ids=["total_above", "total_mixed", "total_below"])
def test_length_regulator_matches_jax(t_feats):
    rng = np.random.default_rng(t_feats)
    hs = rng.standard_normal((3, 9, 5)).astype(np.float32)
    ds = rng.integers(0, 7, (3, 9))
    ds[0, ::2] = 0  # zero durations: tokens skipped
    ds[1] = 0  # no frame at all
    ds[2, -1] = 30  # the last token runs past t_feats
    got = length_regulator(*_t(hs, ds), t_feats, pad_value=-2.0).numpy()
    want = np.asarray(jax_length_regulator(hs, ds, t_feats, pad_value=-2.0))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_duration_predictor_loss_matches_jax():
    rng = np.random.default_rng(2)
    d_outs = rng.standard_normal((3, 10)).astype(np.float32)
    ds = rng.integers(0, 9, (3, 10))
    ilens = np.array([10, 4, 7])
    for masking in (True, False):
        got = get_criterion("DurationPredictorLoss", use_masking=masking)(*_t(d_outs, ds, ilens))
        want = jax_criterion("DurationPredictorLoss", use_masking=masking)(d_outs, ds, ilens)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# -------------------------------------------------------- forward, inference
@pytest.mark.parametrize("kind,cfg,port_kw", MODELS, ids=[m[0] for m in MODELS])
def test_forward_matches_jax(kind, cfg, port_kw):
    port, _, _ = _pair(cfg, port_kw)
    xs, ys, ds = _inputs()
    want = _jax_forward(kind.split("-")[0])[0]
    with torch.no_grad():
        got = port(*_t(xs, LENS, ys, OLENS, ds), None, *_t(xs, LENS))
    for key in ("before_outs", "after_outs", "d_outs"):
        np.testing.assert_allclose(got[key].numpy(), want[key], **TOL, err_msg=key)
    for key in ("ilens", "olens"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])


@pytest.mark.parametrize("kind,cfg,port_kw", MODELS, ids=[m[0] for m in MODELS])
def test_inference_matches_jax(kind, cfg, port_kw):
    port, _, _ = _pair(cfg, port_kw)
    xs, _, _ = _inputs()
    want = _jax_forward(kind.split("-")[0])[1]
    with torch.no_grad():  # the predictor's pre-rounding values
        hs, ilens = port._encode(*_t(xs, LENS))
        valid = make_non_pad_mask(ilens, hs.shape[1])
        log_d = port.duration_predictor(port._dp_features(hs, torch.from_numpy(xs)), ~valid)
    _assert_off_boundaries(log_d[valid].numpy())
    got = port.inference(*_t(xs, LENS, xs), max_output_frames=MAX_OUT)
    for key in ("d_outs", "d_lens", "out_lens"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    assert got["outs"].shape == want["outs"].shape
    for b, n in enumerate(np.minimum(want["out_lens"], MAX_OUT)):
        np.testing.assert_allclose(got["outs"][b, :n].numpy(), want["outs"][b, :n], **TOL)


# ----------------------------------------------------------------- training
OPT = dict(optimizer_params={"lr": 1e-3}, scheduler_params={"warmup_steps": 10}, grad_norm=1.0)
CRITERIA = ("L1Loss", "DurationPredictorLoss")


def _batch():
    xs, ys, ds = _inputs(seed=3)
    return dict(xs=xs, ilens=LENS.astype(np.int32), ys=ys, olens=OLENS.astype(np.int32),
                durations=ds[:, :12],  # shorter than the encoder grid: padded
                duration_lens=np.array([12, 11], np.int32), dp_inputs=xs,
                dplens=LENS.astype(np.int32), utt_ids=["a", "b"])


@functools.lru_cache(maxsize=None)
def _jax_step():
    _, jm, flax = _pair(dict(CONFORMER, **NO_DROPOUT))
    tx, _ = jax_build_optimizer(**OPT)
    trainer = JaxNARVCTrainer(jm, JaxTrainState.create(flax, tx),
                              {n: jax_criterion(n) for n in CRITERIA},
                              dict(train_max_steps=1, seed=0), [], mesh=None, writer=False)
    arrays = trainer._array_batch(_batch())
    rngs = {"dropout": jax.random.PRNGKey(0)}
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: trainer.loss_fn(p, arrays, rngs, trainer._flags()), has_aux=True))(flax)
    return {k: float(v) for k, v in metrics.items()}, grads


@pytest.mark.parametrize("port_kw", [{}, dict(attention_backend="flash", flash_min_len=16)],
                         ids=["xla", "flash"])
def test_trainer_step_matches_jax(port_kw):
    port, _, _ = _pair(dict(CONFORMER, **NO_DROPOUT), port_kw)
    state = TrainState(port, build_optimizer(port.parameters(), **OPT))
    trainer = NARVCTrainer(state, {n: get_criterion(n) for n in CRITERIA},
                           dict(train_max_steps=1, seed=0), [], device="cpu")
    trainer.model.train()
    loss, metrics = trainer.loss_fn(trainer._array_batch(_batch()), (), trainer.generator)
    loss.backward()
    want_terms, want_grads = _jax_step()
    for name in ("l1_loss", "duration_loss"):
        np.testing.assert_allclose(metrics[name].item(), want_terms[name], rtol=1e-5,
                                   err_msg=name)
    want = fastspeech_vc_state_dict(want_grads, port)
    for name, p in port.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        if name.endswith("linear_k.bias"):  # true gradient 0: rounding noise on both sides
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-7, err_msg=name)
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=name)
    assert trainer.has_intermediate() is False


# ---------------------------------------------- AAS-VC, deterministic predictor
@pytest.mark.parametrize("over", [{}, dict(encoder_input_layer="conv2d",
                                            post_encoder_reduction_factor=1)],
                         ids=["linear", "conv2d"])
def test_aasvc_deterministic_predictor_matches_jax(over):
    """Inference, the training forward's loss terms, and the trainer's
    host-side length replica (the forward-sum prior's and the CTC's
    lengths), with the linear or the conv2d encoder input layer."""
    from _torch_port import TINY_AASVC

    cfg = dict(TINY_AASVC, duration_predictor_type="deterministic", duration_predictor_chans=16,
               **NO_DROPOUT, **over)
    port, jm, flax = _pair(cfg, model=AASVC, jax_model=JaxAASVC, convert=convert_aasvc)
    back = aasvc_state_dict(flax, port)
    assert all(torch.equal(back[k], v) for k, v in port.state_dict().items())
    xs, ys, _ = _inputs(seed=4)
    lens, olens = np.array([48, 36]), np.array([64, 50])
    x = xs[:, :48]
    infer, out = jax.jit(lambda p: (
        jm.apply(p, x, lens, x, max_output_frames=MAX_OUT, method=JaxAASVC.inference),
        jm.apply(p, x, lens, ys, olens, x, lens, deterministic=True)))(flax)
    with torch.no_grad():  # the predictor's pre-rounding values
        hs, d_lens = port._encode(*_t(x, lens))
        valid = make_non_pad_mask(d_lens, hs.shape[1])
        log_d = port.duration_predictor(port._dp_features(hs, torch.from_numpy(x)), ~valid)
    _assert_off_boundaries(log_d[valid].numpy())
    got = port.inference(*_t(x, lens, x), max_output_frames=MAX_OUT)
    for key in ("d_outs", "out_lens"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(infer[key]), err_msg=key)
    for b, n in enumerate(np.asarray(infer["out_lens"])):
        np.testing.assert_allclose(got["outs"][b, :n].numpy(), np.asarray(infer["outs"])[b, :n],
                                   **TOL)
    # the training forward's loss terms: L1 and the duration loss on the MAS durations
    with torch.no_grad():
        mine = port(*_t(x, lens, ys, olens, x, lens))
    np.testing.assert_allclose(mine["d_outs"].numpy(), np.asarray(out["d_outs"]), **TOL)
    for name, args in (("L1Loss", ("after_outs", "before_outs", "ys", "olens")),
                       ("DurationPredictorLoss", ("d_outs", "ds", "ilens"))):
        want = jax_criterion(name)(*(out[a] for a in args))
        np.testing.assert_allclose(get_criterion(name)(*(mine[a] for a in args)).item(),
                                   float(want), rtol=1e-5, err_msg=name)
    trainer = AASVCTrainer(
        TrainState(port, build_optimizer(port.parameters())),
        {n: get_criterion(n) for n in CRITERIA}, dict(train_max_steps=1, seed=0), [],
        device="cpu")
    batch = dict(xs=x, ilens=lens, ys=ys, olens=olens, dp_inputs=x, dplens=lens, utt_ids=["a", "b"])
    ilens_r, olens_r, t_text, t_feats = trainer._reduced_lengths(batch)
    np.testing.assert_array_equal(ilens_r, mine["ilens"].numpy())
    assert (t_text, t_feats) == tuple(mine["log_p_attn"].shape[1:][::-1])
    with torch.no_grad():
        _, terms = trainer.loss_fn(trainer._array_batch(batch), trainer._flags(), trainer.generator)
    np.testing.assert_allclose(terms["duration_loss"].item(), float(jax_criterion(
        "DurationPredictorLoss")(out["d_outs"], out["ds"], out["ilens"])), rtol=1e-5)


# ---------------------------------------------------------------- the CLIs
def _corpus(root: Path, teacher_factor: int):
    """4 parallel utterances as ``.npy`` + scp, and teacher durations per
    encoder frame summing to the target length over the teacher factor,
    as ``<utt>.txt`` files written the way ``vc_decode`` writes them."""
    rng = np.random.default_rng(7)
    root.mkdir(parents=True)
    scps = {"src": [], "trg": []}
    (root / "durations").mkdir()
    for i, (n_src, n_trg) in enumerate(((40, 44), (47, 50), (33, 36), (52, 49))):
        for side, n in (("src", n_src), ("trg", n_trg)):
            np.save(root / f"{side}{i}.npy", (-4 + rng.standard_normal((n, 80))).astype(np.float32))
            scps[side].append(f"utt{i} {root / f'{side}{i}.npy'}")
        t_enc = int(conv2d_subsampled_lengths(torch.tensor(n_src)))
        d = rng.multinomial(n_trg // teacher_factor, np.ones(t_enc) / t_enc)
        np.savetxt(root / "durations" / f"utt{i}.txt", d[None], fmt="%d")
    for side, lines in scps.items():
        (root / f"{side}.scp").write_text("\n".join(lines) + "\n")
    return str(root / "src.scp"), str(root / "trg.scp"), str(root / "durations")


def _write_conf(path: Path, conf: Path, **model_params):
    config = load_config(str(conf))
    config["model_params"] = dict(config["model_params"], **model_params)
    config.update(batch_size=2, eval_interval_steps=2, save_interval_steps=2,
                  log_interval_steps=1)
    path.write_text(yaml.safe_dump(config))
    return config


@pytest.mark.parametrize("conf,over", [(ARCTIC, dict(SMALL, conformer_enc_kernel_size=7,
                                                      conformer_dec_kernel_size=7)),
                                        (SYNTH, {})], ids=["arctic", "synth"])
def test_vc_train_with_teacher_durations_resumes_exactly(tmp_path, conf, over):
    """2 steps, then --resume to 4, equals 4 straight steps, the conf's
    dropout on; the dev evaluation writes no predictions (no
    generate_intermediate, as in the JAX trainer)."""
    config = _write_conf(tmp_path / "conf.yaml", conf, **over)
    src, trg, dur = _corpus(tmp_path / "corpus", config["model_params"][
        "teacher_model_decoder_reduction_factor"])
    args = ["--src-train-dumpdir", src, "--src-dev-dumpdir", src, "--trg-train-dumpdir", trg,
            "--trg-dev-dumpdir", trg, "--train-duration-dir", dur, "--dev-duration-dir", dur,
            "--config", str(tmp_path / "conf.yaml"), "--device", "cpu"]
    if not config["model_params"]["duration_predictor_use_encoder_outputs"]:
        args += ["--train-dp-input-dir", src, "--dev-dp-input-dir", src]

    def run(steps, outdir, *extra):
        (tmp_path / f"steps{steps}.yaml").write_text(yaml.safe_dump({"train_max_steps": steps}))
        return vc_train.main(args + ["--additional-config", str(tmp_path / f"steps{steps}.yaml"),
                                     "--outdir", str(tmp_path / outdir), *extra])

    first = run(2, "first")
    assert any("dev/duration_loss" in h for h in first.history)
    assert not (tmp_path / "first" / "predictions").exists()
    resumed = run(4, "resumed", "--resume", str(tmp_path / "first" / "checkpoint-2steps.pt"))
    straight = run(4, "straight")
    assert resumed.steps == straight.steps == 4
    a = torch.load(tmp_path / "resumed" / "checkpoint-4steps.pt", weights_only=True)["model"]
    b = torch.load(tmp_path / "straight" / "checkpoint-4steps.pt", weights_only=True)["model"]
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert all(np.isfinite(h["train/loss"]) for h in straight.history if "train/loss" in h)


def test_vc_decode_matches_jax_inference(tmp_path):
    config = _write_conf(tmp_path / "conf.yaml", SYNTH)
    port, jm, flax = _pair(config["model_params"], seed=5)
    exp = tmp_path / "exp"
    exp.mkdir()
    (exp / "config.yml").write_text((tmp_path / "conf.yaml").read_text())
    torch.save({"model": port.state_dict()}, exp / "checkpoint-0steps.pt")
    src, _, _ = _corpus(tmp_path / "corpus", 2)
    out = tmp_path / "out"
    vc_decode.main(["--dumpdir", src, "--checkpoint", str(exp / "checkpoint-0steps.pt"),
                    "--outdir", str(out), "--batch-size", "2", "--device", "cpu"])
    feats = {line.split()[0]: np.load(line.split()[1])
             for line in (out / "feats.scp").read_text().splitlines()}
    arrays = {line.split()[0]: np.load(line.split()[1]) for line in open(src).read().splitlines()}
    infer = jax.jit(lambda p, xs, ilens: jm.apply(p, xs, ilens, None,
                                                  max_output_frames=2 * xs.shape[1],
                                                  method=JaxFastSpeechVC.inference))
    order = sorted(arrays, key=lambda u: (len(arrays[u]), u))
    for group in (order[:2], order[2:]):
        t = -(-max(len(arrays[u]) for u in group) // vc_decode.BUCKET_FRAMES)
        xs = np.zeros((2, t * vc_decode.BUCKET_FRAMES, 80), np.float32)
        for b, u in enumerate(group):
            xs[b, : len(arrays[u])] = arrays[u]
        ilens = np.array([len(arrays[u]) for u in group])
        ref = jax.tree_util.tree_map(np.asarray, infer(flax, xs, ilens))
        with torch.no_grad():  # the predictor's pre-rounding values
            hs, d_lens = port._encode(*_t(xs, ilens))
            log_d = port.duration_predictor(hs).numpy()
        for b, u in enumerate(group):
            d_len = int(ref["d_lens"][b])
            _assert_off_boundaries(log_d[b, :d_len])
            n = min(int(ref["out_lens"][b]), ref["outs"].shape[1])
            assert feats[u].shape == (n, 80)
            np.testing.assert_allclose(feats[u], ref["outs"][b, :n], **TOL)
            dur = np.loadtxt(out / "durations" / f"{u}.txt", dtype=np.int64, ndmin=1)
            np.testing.assert_array_equal(dur, ref["d_outs"][b, :d_len])
