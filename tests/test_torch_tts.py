"""Port: Transformer-TTS (seq2seq_vc_torch/text, bin/tokenize_text.py,
train/tts_data.py, nn/transformer.py's ``embed`` input layer,
models/transformer_tts.py, convert.transformer_tts_state_dict,
losses/guided_attention.py, train/ar_tts.py, bin/tts_train.py and
bin/tts_decode.py) against the JAX package.

The tiny Transformer-TTS of ``tests/_torch_port.py`` is built in the port
from a seed; its weights go to flax through the JAX package's
``convert_transformer_tts`` and back through the port's converter. Every
dropout is 0 on both sides (the prenet's always-on bits cannot be
reproduced across frameworks); the JAX loss function runs deterministic.
The JAX CLIs are not run in-process (they turn on JAX's persistent
compilation cache): the JAX functions are called directly.

Tolerances (float32): the text front end, the collater and the dataset
exactly; attention maps atol 1e-5; encoder states and teacher-forced
outputs atol 2e-5 (sums in another order through a few layers); AR
decodes atol 1e-4 (each step feeds the last frame back); the guided losses
rtol 1e-6; the trainer step as tests/test_torch_vtn_train.py holds the
VTN's: loss terms rtol 1e-5, each gradient tensor within 1e-4 of its
largest magnitude (the ``linear_k`` biases, true gradient 0, to rounding
noise: atol 1e-7), parameters after one clipped Adam step atol 1e-5.
"""

import functools
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from _torch_port import (  # noqa: F401 (release_jax_executables: autouse fixture)
    NO_DROPOUT,
    assert_state_dicts_equal,
    release_jax_executables,
    tts_pair,
)
from seq2seq_vc_tpu.bin import tokenize_text as jax_tokenize_text
from seq2seq_vc_tpu.losses import GuidedAttentionLoss as JaxGuidedAttentionLoss
from seq2seq_vc_tpu.losses import GuidedMultiHeadAttentionLoss as JaxGuidedMHALoss
from seq2seq_vc_tpu.losses import get_criterion as jax_criterion
from seq2seq_vc_tpu.models import TransformerTTS as JaxTransformerTTS
from seq2seq_vc_tpu.models import ar_driver as jax_ar_driver
from seq2seq_vc_tpu.text import TextCleaner as JaxTextCleaner
from seq2seq_vc_tpu.text import TokenIDConverter as JaxTokenIDConverter
from seq2seq_vc_tpu.text import build_tokenizer as jax_build_tokenizer
from seq2seq_vc_tpu.train.ar_tts import ARTTSTrainer as JaxARTTSTrainer
from seq2seq_vc_tpu.train.optim import build_optimizer as jax_build_optimizer
from seq2seq_vc_tpu.train.state import TrainState as JaxTrainState
from seq2seq_vc_tpu.train.tts_data import ARTTSCollater as JaxARTTSCollater
from seq2seq_vc_tpu.train.tts_data import TTSDataset as JaxTTSDataset
from seq2seq_vc_tpu.vocoder.griffin_lim import griffin_lim as jax_griffin_lim
from seq2seq_vc_torch.bin import tokenize_text, tts_decode, tts_train
from seq2seq_vc_torch.convert import transformer_tts_state_dict
from seq2seq_vc_torch.losses import GuidedAttentionLoss, GuidedMultiHeadAttentionLoss
from seq2seq_vc_torch.losses import get_criterion
from seq2seq_vc_torch.models import get_model_class
from seq2seq_vc_torch.models.ar_driver import ChunkedARDecoder
from seq2seq_vc_torch.models.transformer_tts import TransformerTTS
from seq2seq_vc_torch.text import TextCleaner, TokenIDConverter, build_tokenizer
from seq2seq_vc_torch.train import get_trainer_class
from seq2seq_vc_torch.train.ar_tts import ARTTSTrainer
from seq2seq_vc_torch.train.optim import build_optimizer
from seq2seq_vc_torch.train.state import TrainState
from seq2seq_vc_torch.train.tts_data import ARTTSCollater, TTSDataset, read_2column_text
from seq2seq_vc_torch.vocoder.griffin_lim import griffin_lim

ATT_TOL = dict(atol=1e-5, rtol=0)
TOL = dict(atol=2e-5, rtol=0)
AR_TOL = dict(atol=1e-4, rtol=0)
KEY = jax.random.PRNGKey(0)
SYNTH = "egs/synth/tts1/conf/tts.synth.yaml"
SENTENCES = (
    "Printing, in the only sense with which we are at present concerned,",
    "Mr. Oswald was 24 years old in 1963; he paid $13.50 for it.",
    "the quick brown fox jumps over a lazy dog near blue lake",
    "It's the 2nd time Dr. Smith wrote 'hello' -- and 100% of them agreed!",
)
OPT = dict(optimizer_params={"lr": 1e-3}, scheduler_params={"warmup_steps": 10}, grad_norm=1.0)
CONFIG = dict(train_max_steps=1, log_interval_steps=1, seed=0, use_guided_attn_loss=True)
GA = dict(sigma=0.4, alpha=1.0)
TERMS = ("l1_loss", "bce_loss", "guided_attn_loss")


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _batch(seed=0, B=2, T=13, L=40):
    """Token ids (1..idim-2; 0 pads) with their lengths, mels, stop labels."""
    rng = np.random.default_rng(seed)
    ilens = np.array([T, T - 4], np.int32)
    xs = rng.integers(1, 19, (B, T)).astype(np.int32) * (np.arange(T)[None] < ilens[:, None])
    ys = rng.standard_normal((B, L, 80)).astype(np.float32)
    olens = np.array([L, L - 11], np.int32)
    labels = (np.arange(L)[None, :] >= olens[:, None] - 1).astype(np.float32)
    return xs.astype(np.int32), ilens, ys, labels, olens


@pytest.fixture(scope="module")
def pair():
    return tts_pair(seed=0, **NO_DROPOUT)


@pytest.mark.parametrize("token_type,g2p", [("char", None), ("phn", "g2p_en"), ("word", None)])
def test_text_front_end_matches_jax(token_type, g2p):
    vocab = ["<blank>", "<unk>", "AH0", "T", "a", "e", "t", "the", "<space>", "<sos/eos>"]
    for text in SENTENCES:
        cleaned = TextCleaner("tacotron")(text)
        assert cleaned == JaxTextCleaner("tacotron")(text)
        got = build_tokenizer(token_type=token_type, g2p_type=g2p).text2tokens(cleaned)
        want = jax_build_tokenizer(token_type=token_type, g2p_type=g2p).text2tokens(cleaned)
        assert got == want and got
        ids = TokenIDConverter(vocab, unk_symbol="<unk>").tokens2ids(got)
        assert ids == JaxTokenIDConverter(vocab, unk_symbol="<unk>").tokens2ids(want)


def _write_corpus(root, n=6, seed=0):
    """A 2-column text file and ``.npy`` mels with a ``feats.scp``."""
    rng = np.random.default_rng(seed)
    text, scp = [], []
    for i in range(n):
        utt = f"utt{i:03d}"
        mel = rng.standard_normal((int(rng.integers(30, 70)), 80)).astype(np.float32)
        np.save(root / f"{utt}.npy", mel)
        text.append(f"{utt} {SENTENCES[i % len(SENTENCES)]}")
        scp.append(f"{utt} {root / f'{utt}.npy'}")
    (root / "text").write_text("\n".join(text) + "\n")
    (root / "feats.scp").write_text("\n".join(scp) + "\n")
    return root / "text", root / "feats.scp"


def test_tokenize_text_matches_jax(tmp_path, monkeypatch):
    text, _ = _write_corpus(tmp_path)
    args = ["--input", str(text), "--token_type", "phn", "--g2p", "g2p_en", "--cleaner",
            "tacotron", "--add_symbol", "<pad>:2"]
    got = tokenize_text.main(args + ["--output", str(tmp_path / "port.txt")])
    monkeypatch.setattr(sys, "argv", ["tokenize_text"] + args + ["--output",
                                                                 str(tmp_path / "jax.txt")])
    jax_tokenize_text.main()
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    assert got[0] == "<blank>" and got[2] == "<pad>" and got[-1] == "<sos/eos>"
    assert read_2column_text(str(text))["utt001"] == SENTENCES[1]


def test_dataset_and_collater_match_jax(tmp_path):
    text, scp = _write_corpus(tmp_path)
    tokenize_text.main(["--input", str(text), "--output", str(tmp_path / "tokens.txt"),
                        "--token_type", "char", "--cleaner", "tacotron"])
    tokens = (tmp_path / "tokens.txt").read_text().split("\n")[:-1]
    kw = dict(non_linguistic_symbols=None, cleaner="tacotron", g2p=None, token_list=tokens,
              token_type="char", feat_key="mel")
    got, want = TTSDataset(str(scp), str(text), **kw), JaxTTSDataset(str(scp), str(text), **kw)
    assert got.utt_ids == want.utt_ids and len(got) == 6
    items = [got[i] for i in range(len(got))]
    for i, item in enumerate(items):
        assert got.length(i) == item["trg_feat"].shape[0]
        for k, v in want[i].items():
            np.testing.assert_array_equal(item[k], v, err_msg=k)
    for pad, r in ((32, 1), (16, 3)):
        a, b = ARTTSCollater(pad, r)(items[:4]), JaxARTTSCollater(pad, r)(items[:4])
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_weights_round_trip(pair):
    port, _, flax = pair
    assert_state_dicts_equal(transformer_tts_state_dict(flax, port), port.state_dict())
    assert tuple(port.state_dict()["encoder.embed.0.weight"].shape) == (20, 32)
    assert "encoder.embed.1.alpha" in port.state_dict()
    assert get_model_class("TransformerTTS") is TransformerTTS
    assert get_trainer_class("ARTTSTrainer") is ARTTSTrainer


def test_encoder_with_embed_matches_jax(pair):
    port, jax_model, flax = pair
    xs, ilens = _batch()[:2]
    want, want_mask = jax_model.apply(flax, xs, ilens, method=JaxTransformerTTS.encode)
    got, mask = port.encode(*_t(xs, ilens))
    assert got.shape == (2, 14, 32)  # eos appended
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    eos = port._add_eos(*_t(xs, ilens))[0]
    assert eos[0, 13] == 19 and eos[1, 9] == 19 and (eos[1, 10:] == 0).all()


def test_teacher_forced_forward_matches_jax(pair):
    port, jax_model, flax = pair
    batch = _batch(seed=1)
    want = jax_model.apply(flax, *batch, deterministic=True, rngs={"dropout": KEY})
    port.postnet.dropout_rate = 0.0
    got = port(*_t(*batch))
    assert set(got) == set(want)
    assert got["att_ws"].shape == (2, 4, 40, 14)  # 2 layers x 2 heads, T + eos
    for k in want:
        tol = ATT_TOL if k == "att_ws" else TOL
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), err_msg=k,
                                   **tol)


@pytest.mark.parametrize("speculate", [True, False])
def test_chunked_decode_matches_jax(pair, speculate):
    port, jax_model, flax = pair
    xs, ilens = _batch(seed=2)[:2]
    kw = dict(threshold=1.1, minlenratio=0.0, maxlenratio=2.0, base_chunk=4, max_chunk=8,
              speculate=speculate)
    want = jax_ar_driver.ChunkedARDecoder(jax_model, JaxTransformerTTS, **kw)(flax, xs, ilens,
                                                                             KEY)
    got = ChunkedARDecoder(port, **kw)(*_t(xs, ilens))
    # the budget counts the eos: 2 x (13 + 1) and 2 x (9 + 1) steps
    np.testing.assert_array_equal(got["out_lens"].numpy(), [28, 20])
    np.testing.assert_array_equal(got["out_lens"].numpy(), np.asarray(want["out_lens"]))
    for k in ("outs", "probs", "att_ws"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **AR_TOL)
    full = port.inference(*_t(xs, ilens), threshold=1.1, maxlenratio=2.0)
    np.testing.assert_array_equal(full["out_lens"].numpy(), got["out_lens"].numpy())


@pytest.mark.parametrize("multi", [False, True])
def test_guided_attention_losses_match_jax(multi):
    rng = np.random.default_rng(3)
    B, H, To, Ti = 3, 4, 17, 11
    att = rng.random((B, H, To, Ti) if multi else (B, To, Ti)).astype(np.float32)
    ilens, olens = np.array([11, 7, 0], np.int32), np.array([17, 9, 5], np.int32)
    kw = dict(sigma=0.3, alpha=2.0)
    jax_loss, loss = ((JaxGuidedMHALoss, GuidedMultiHeadAttentionLoss) if multi
                      else (JaxGuidedAttentionLoss, GuidedAttentionLoss))
    want = float(jax_loss(**kw)(att, ilens, olens))
    got = loss(**kw)(*_t(att, ilens, olens)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if multi:  # a (B, L, H, ...) stack reads as (B, L * H, ...)
        stack = att.reshape(B, 2, 2, To, Ti)
        np.testing.assert_allclose(loss(**kw)(*_t(stack, ilens, olens)).item(), want, rtol=1e-6)


def _criterion():
    return {"Seq2SeqLoss": get_criterion("Seq2SeqLoss", bce_pos_weight=5.0),
            "guided_attn": GuidedMultiHeadAttentionLoss(**GA)}


def _step_batch():
    batch = dict(zip(("xs", "ilens", "ys", "labels", "olens"), _batch(seed=4, T=15, L=48)))
    batch["utt_ids"] = ["a", "b"]
    return batch


@functools.lru_cache(maxsize=None)
def _jax_step():
    """The JAX ARTTSTrainer's step: (loss terms, gradient tree, updated params)."""
    _, jax_model, flax = tts_pair(seed=5, **NO_DROPOUT)
    tx, _ = jax_build_optimizer(**OPT)
    criterion = {"Seq2SeqLoss": jax_criterion("Seq2SeqLoss", bce_pos_weight=5.0),
                 "guided_attn": JaxGuidedMHALoss(**GA)}
    trainer = JaxARTTSTrainer(jax_model, JaxTrainState.create(flax, tx), criterion,
                              dict(CONFIG), [], mesh=None, writer=False)
    arrays = trainer._array_batch(_step_batch())
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: trainer.loss_fn(p, arrays, {"dropout": KEY}, trainer._flags(),
                                  deterministic=True), has_aux=True))(flax)
    new = trainer.state.apply_gradients(grads).params
    return {k: float(v) for k, v in metrics.items()}, grads, new


@functools.lru_cache(maxsize=None)
def _port_step():
    port, _, _ = tts_pair(seed=5, **NO_DROPOUT)
    port.postnet.dropout_rate = 0.0
    state = TrainState(port, build_optimizer(port.parameters(), **OPT))
    trainer = ARTTSTrainer(state, _criterion(), dict(CONFIG), [], device="cpu")
    trainer.model.train()
    loss, metrics = trainer.loss_fn(trainer._array_batch(_step_batch()), trainer._flags(),
                                    trainer.generator)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in trainer.model.named_parameters()}
    trainer.state.apply_gradients()
    new = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    return {k: v.item() for k, v in metrics.items()}, grads, new, trainer.model


def test_tts_step_loss_terms_match_jax():
    want, got = _jax_step()[0], _port_step()[0]
    assert set(got) == set(TERMS) and got["guided_attn_loss"] > 0
    for name in TERMS:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, err_msg=name)


def test_tts_step_gradients_match_jax():
    _, grads, _, model = _port_step()
    want = transformer_tts_state_dict(_jax_step()[1], model)
    assert set(grads) == set(want)
    assert grads["encoder.embed.0.weight"].abs().max() > 0
    for k, g in grads.items():
        w = want[k]
        if k.endswith("linear_k.bias"):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-7, rtol=0, err_msg=k)
            continue
        top = float(w.abs().max())
        assert top > 0, k
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4 * top, rtol=0, err_msg=k)


def test_tts_step_updated_parameters_match_jax():
    _, _, new, model = _port_step()
    want = transformer_tts_state_dict(_jax_step()[2], model)
    for k, v in new.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5, rtol=0, err_msg=k)


def test_griffin_lim_of_two_frames_matches_jax():
    """A decode that stops at once gives one or two frames: the signal is
    shorter than the STFT's centre padding, which numpy's (and JAX's)
    reflect padding reflects again."""
    rng = np.random.default_rng(6)
    for n_frames in (1, 2, 5):
        spc = rng.random((n_frames, 513)).astype(np.float32)
        angles = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), spc.shape))
        want = jax_griffin_lim(spc, 1024, 256, n_iter=4)
        got = griffin_lim(spc, 1024, 256, n_iter=4, angles=angles, device="cpu")
        assert got.shape == want.shape == (256 * n_frames,)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _tts_cli(tmp_path, text, scp, tokens, outdir, steps, resume=None):
    over = tmp_path / f"over{steps}.yaml"
    over.write_text(yaml.safe_dump(dict(train_max_steps=steps, save_interval_steps=2,
                                        eval_interval_steps=2, log_interval_steps=1)))
    args = ["--train-dumpdir", str(scp), "--dev-dumpdir", str(scp), "--train-text", str(text),
            "--dev-text", str(text), "--token-list", str(tokens), "--token-type", "phn",
            "--g2p", "g2p_en", "--config", SYNTH, "--additional-config", str(over),
            "--outdir", str(outdir), "--device", "cpu"]
    return tts_train.main(args + (["--resume", str(resume)] if resume else []))


def test_tts_train_resume_is_exact_and_tts_decode_runs(tmp_path):
    text, scp = _write_corpus(tmp_path)
    tokens = tmp_path / "tokens.txt"
    tokenize_text.main(["--input", str(text), "--output", str(tokens), "--token_type", "phn",
                        "--g2p", "g2p_en", "--cleaner", "tacotron"])
    straight = _tts_cli(tmp_path, text, scp, tokens, tmp_path / "straight", 4)
    _tts_cli(tmp_path, text, scp, tokens, tmp_path / "resumed", 2)
    resumed = _tts_cli(tmp_path, text, scp, tokens, tmp_path / "resumed", 4,
                       resume=tmp_path / "resumed" / "checkpoint-2steps.pt")
    assert straight.steps == resumed.steps == 4
    assert all(np.isfinite(h["train/guided_attn_loss"]) and h["train/guided_attn_loss"] > 0
               for h in straight.history if "train/loss" in h)
    a, b = (torch.load(tmp_path / d / "checkpoint-4steps.pt", weights_only=True)["model"]
            for d in ("straight", "resumed"))
    assert_state_dicts_equal(a, b)
    assert len(list((tmp_path / "straight" / "predictions" / "4steps").glob("*.npy"))) == 2

    (tmp_path / "decode_text").write_text("d0 The fox.\nd1 Printing, in the only sense.\n")
    out = tts_decode.main(["--text", str(tmp_path / "decode_text"), "--checkpoint",
                           str(tmp_path / "straight" / "checkpoint-4steps.pt"),
                           "--token-list", str(tokens), "--token-type", "phn", "--g2p",
                           "g2p_en", "--outdir", str(tmp_path / "dec"), "--device", "cpu"])
    feats = [np.load(tmp_path / "dec" / f"d{i}.npy") for i in range(2)]
    assert out["frames"] == sum(len(f) for f in feats) > 0
    assert all(f.shape[1] == 80 and np.isfinite(f).all() for f in feats)
    assert sorted(p.name for p in (tmp_path / "dec" / "wav").glob("*.wav")) == ["d0.wav",
                                                                                "d1.wav"]
    assert len((tmp_path / "dec" / "feats.scp").read_text().splitlines()) == 2
