"""Port: the VTN's TTS pretraining (seq2seq_vc_torch/core/checkpoint.py's
``partial_transfer``, train/optim.py's ``freeze_mods``, train/ar_vc.py's
guided-attention term and bin/vc_train.py's ``--init-checkpoint``,
``init-mods`` and ``freeze-mods``) against the JAX package.

``init-mods`` and ``freeze-mods`` name modules of the JAX parameter tree:
the port resolves each torch key to its flax path, so ``decoder`` neither
transfers nor freezes the prenet (``dprenet``, ``dprenet_proj``), as in
the JAX package. The transfer is held against JAX's ``partial_transfer``
on the converted trees, the freeze mask against ``_freeze_mask_fn``'s
labels and the frozen update against ``optax.multi_transform``'s. No JAX CLI
runs in-process: the effective AEPT config is held against JAX's
``merge_args``.

Tolerances (float32): transfers and frozen tensors bit for bit; Adam
updates atol 1e-6 (one clipped step from the same gradients); the
``ARVCTrainer`` step with the guided term as tests/test_torch_vtn_train.py
holds the VTN's: loss terms rtol 1e-5, each gradient within 1e-4 of its
tensor's largest magnitude, the ``linear_k`` biases atol 1e-7.
"""

import functools

import jax
import numpy as np
import optax
import pytest
import torch
import yaml

from _torch_port import (  # noqa: F401 (release_jax_executables: autouse fixture)
    NO_DROPOUT,
    assert_state_dicts_equal,
    release_jax_executables,
    tts_pair,
    vtn_pair,
)
from seq2seq_vc_tpu.convert.reference import convert_vtn
from seq2seq_vc_tpu.core.checkpoint import partial_transfer as jax_partial_transfer
from seq2seq_vc_tpu.core.config import load_config as jax_load_config
from seq2seq_vc_tpu.core.config import merge_args as jax_merge_args
from seq2seq_vc_tpu.losses import GuidedMultiHeadAttentionLoss as JaxGuidedMHALoss
from seq2seq_vc_tpu.losses import get_criterion as jax_criterion
from seq2seq_vc_tpu.train.ar_vc import ARVCTrainer as JaxARVCTrainer
from seq2seq_vc_tpu.train.data import ARVCCollater
from seq2seq_vc_tpu.train.optim import _freeze_mask_fn
from seq2seq_vc_tpu.train.optim import build_optimizer as jax_build_optimizer
from seq2seq_vc_tpu.train.state import TrainState as JaxTrainState
from seq2seq_vc_torch.bin import tokenize_text, tts_train, vc_train
from seq2seq_vc_torch.convert import flax_paths, vtn_state_dict
from seq2seq_vc_torch.core.checkpoint import module_keys, partial_transfer
from seq2seq_vc_torch.losses import GuidedMultiHeadAttentionLoss, get_criterion
from seq2seq_vc_torch.models.vtn import VTN
from seq2seq_vc_torch.train.ar_vc import ARVCTrainer
from seq2seq_vc_torch.train.optim import build_optimizer, frozen_names
from seq2seq_vc_torch.train.state import TrainState

AEPT = "egs/ljspeech/tts1/conf/tts_aept.v1.yaml"
SYNTH = "egs/synth/tts1/conf/tts.synth.yaml"
AEPT_MODS = ["decoder", "feat_out", "prob_out", "postnet"]
OPT = dict(optimizer_params={"lr": 1e-3}, scheduler_params={"warmup_steps": 10}, grad_norm=1.0)
GA = dict(sigma=0.4, alpha=1.0)
KEY = jax.random.PRNGKey(0)


def _vtn(seed=1, **over):
    """The tiny VTN at r 1, whose decoder side matches the tiny TTS's."""
    return vtn_pair(seed=seed, decoder_reduction_factor=1, **over)


@pytest.mark.parametrize("mods", [
    AEPT_MODS,
    ["decoder/layers_0", "dprenet", "encoder", "nothing"],  # whole roots; shapes; absent
    ["dprenet_proj", "postnet.0"],
])
def test_partial_transfer_matches_jax(mods):
    tts, _, tts_flax = tts_pair(seed=0)
    vtn, jax_vtn, vtn_flax = _vtn()
    want = vtn_state_dict(jax_partial_transfer(vtn_flax, tts_flax, mods), vtn)
    got, done = partial_transfer(vtn, tts.state_dict(), mods)
    assert_state_dicts_equal(got, want)
    before = vtn.state_dict()
    changed = {k for k in got if not torch.equal(got[k], before[k])}
    roots = module_keys(vtn)
    assert changed == {k for m in done for k in roots[m]}
    if mods == AEPT_MODS:
        assert done == AEPT_MODS
        # the prenet and its projection are not the JAX module "decoder"
        assert not any(k.startswith("decoder.embed.0.") for k in changed)
        assert "decoder.embed.1.alpha" in changed and "decoder.decoders.1.norm3.bias" in changed
    if "encoder" in mods:  # the TTS encoder embeds tokens: its shapes differ
        assert "encoder" not in done and "dprenet" in done and "decoder" in done


def test_flax_paths_name_jax_modules():
    vtn, _, vtn_flax = _vtn()
    paths = flax_paths(vtn)
    leaves = {"/".join(str(p.key) for p in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(vtn_flax)[0]}
    assert {"params/" + p for p in paths.values()} == leaves
    assert paths["decoder.embed.0.0.prenet.0.0.weight"] == "dprenet/Dense_0/kernel"
    assert paths["decoder.embed.1.alpha"] == "decoder/pos_enc/alpha"


def _labels(flax, mods):
    """The flax paths that ``_freeze_mask_fn`` labels frozen."""
    labels = _freeze_mask_fn(mods)(flax)
    return {"/".join(str(p.key) for p in path)
            for path, label in jax.tree_util.tree_flatten_with_path(labels)[0]
            if label == "frozen"}


@pytest.mark.parametrize("mods", [AEPT_MODS, ["encoder", "decoder/layers_1"], ["params/dprenet"]])
def test_freeze_mods_step_matches_jax_multi_transform(mods):
    port, jax_model, flax = _vtn(seed=2)
    paths = flax_paths(port)
    names = frozen_names(port, mods)
    assert {"params/" + paths[n] for n in names} == _labels(flax, mods)
    rng = np.random.default_rng(3)
    params = dict(port.named_parameters())
    opt = build_optimizer(port, **OPT, freeze_mods=mods)
    assert {n for n, p in params.items() if not p.requires_grad} == set(names)
    tx, _ = jax_build_optimizer(**OPT, freeze_mods=mods)
    jp = jax.tree_util.tree_map(np.asarray, flax)
    js = tx.init(jp)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    for _ in range(2):
        # the frozen gradients are large: the clip would read them if it saw them
        grads = {n: torch.from_numpy(np.asarray(rng.standard_normal(tuple(p.shape)) * (
            50.0 if n in names else 0.2), np.float32)) for n, p in params.items()}
        for n, p in params.items():
            if p.requires_grad:
                p.grad = grads[n].clone()
        norm = opt.step()
        upd, js = tx.update(convert_vtn(grads, jax_model), js, jp)
        jp = optax.apply_updates(jp, upd)
        assert norm > 1.0  # the clip acts
    want = vtn_state_dict(jp, port)
    for k, v in port.state_dict().items():
        if k in names:
            assert torch.equal(v, before[k]), k
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-6, rtol=0, err_msg=k)
    assert sum(len(s) > 0 for s in opt.adam.state.values()) == len(params) - len(names)
    with pytest.raises(ValueError, match="the model"):
        build_optimizer(port.parameters(), freeze_mods=mods)


def _items(seed=0, lens=((44, 37), (48, 40), (31, 29))):
    rng = np.random.default_rng(seed)
    return [{"utt_id": f"u{i}", "src_feat": rng.standard_normal((s, 80)).astype(np.float32),
             "trg_feat": rng.standard_normal((t, 80)).astype(np.float32)}
            for i, (s, t) in enumerate(lens)]


CONFIG = dict(train_max_steps=1, log_interval_steps=1, seed=0, use_guided_attn_loss=True)
TERMS = ("l1_loss", "bce_loss", "guided_attn_loss")
SMALL = dict(elayers=1, dlayers=1)


@functools.lru_cache(maxsize=None)
def _jax_vc_step():
    _, jax_model, flax = vtn_pair(seed=4, **SMALL, **NO_DROPOUT)
    tx, _ = jax_build_optimizer(**OPT)
    criterion = {"Seq2SeqLoss": jax_criterion("Seq2SeqLoss", bce_pos_weight=10.0),
                 "guided_attn": JaxGuidedMHALoss(**GA)}
    trainer = JaxARVCTrainer(jax_model, JaxTrainState.create(flax, tx), criterion, dict(CONFIG),
                             [], mesh=None, writer=False)
    arrays = trainer._array_batch(ARVCCollater(16, 4)(_items()))
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: trainer.loss_fn(p, arrays, {"dropout": KEY}, trainer._flags(),
                                  deterministic=True), has_aux=True))(flax)
    return {k: float(v) for k, v in metrics.items()}, grads


def test_arvc_step_with_guided_attention_matches_jax():
    from seq2seq_vc_torch.train.data import ARVCCollater as PortCollater

    port, _, _ = vtn_pair(seed=4, **SMALL, **NO_DROPOUT)
    port.postnet.dropout_rate = 0.0
    criterion = {"Seq2SeqLoss": get_criterion("Seq2SeqLoss", bce_pos_weight=10.0),
                 "guided_attn": GuidedMultiHeadAttentionLoss(**GA)}
    trainer = ARVCTrainer(TrainState(port, build_optimizer(port.parameters(), **OPT)),
                          criterion, dict(CONFIG), [], device="cpu")
    trainer.model.train()
    loss, metrics = trainer.loss_fn(trainer._array_batch(PortCollater(16, 4)(_items())),
                                    trainer._flags(), trainer.generator)
    loss.backward()
    want, jax_grads = _jax_vc_step()
    assert set(metrics) == set(TERMS) and metrics["guided_attn_loss"] > 0
    for name in TERMS:
        np.testing.assert_allclose(metrics[name].item(), want[name], rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(loss.item(), sum(want[n] for n in TERMS), rtol=1e-5)
    ref = vtn_state_dict(jax_grads, port)
    for k, p in port.named_parameters():
        g, w = p.grad, ref[k]
        if k.endswith("linear_k.bias"):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-7, rtol=0, err_msg=k)
            continue
        top = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4 * top, rtol=0, err_msg=k)
    # without the criterion, or with the flag off, no guided term (as in JAX)
    for config, crit in ((CONFIG, {"Seq2SeqLoss": criterion["Seq2SeqLoss"]}),
                         (dict(CONFIG, use_guided_attn_loss=False), criterion)):
        t = ARVCTrainer(trainer.state, crit, dict(config), [], device="cpu")
        assert t.guided_attn() is None


def _corpus(root, n=6, seed=0):
    rng = np.random.default_rng(seed)
    words = "the quick brown fox jumps over a lazy dog near blue lake".split()
    text, scp = [], []
    for i in range(n):
        np.save(root / f"u{i}.npy",
                rng.standard_normal((int(rng.integers(40, 80)), 80)).astype(np.float32))
        text.append(f"u{i} " + " ".join(rng.choice(words, 5)))
        scp.append(f"u{i} {root / f'u{i}.npy'}")
    (root / "text").write_text("\n".join(text) + "\n")
    (root / "feats.scp").write_text("\n".join(scp) + "\n")
    return root / "text", root / "feats.scp"


def test_vc_train_aept_from_a_tts_checkpoint(tmp_path):
    """egs/ljspeech/tts1/run.sh stages 3 and 6 at the synth conf's widths:
    tts_train, then vc_train with the TTS conf, tts_aept.v1.yaml (its
    model widths cut to the synth conf's, its steps to 2) and the TTS
    checkpoint."""
    text, scp = _corpus(tmp_path)
    tokens = tmp_path / "tokens.txt"
    tokenize_text.main(["--input", str(text), "--output", str(tokens), "--token_type", "char",
                        "--cleaner", "tacotron"])
    steps = tmp_path / "steps.yaml"
    steps.write_text(yaml.safe_dump(dict(train_max_steps=1, save_interval_steps=0)))
    tts_train.main(["--train-dumpdir", str(scp), "--dev-dumpdir", str(scp), "--train-text",
                    str(text), "--dev-text", str(text), "--token-list", str(tokens), "--config",
                    SYNTH, "--additional-config", str(steps), "--outdir", str(tmp_path / "tts"),
                    "--device", "cpu"])
    tts_ckpt = tmp_path / "tts" / "checkpoint-1steps.pt"

    synth = jax_load_config(SYNTH)
    aept = jax_load_config(AEPT)
    widths = ("dprenet_units", "adim", "aheads", "elayers", "eunits", "dlayers", "dunits",
              "postnet_layers", "postnet_chans")
    aept["model_params"].update({k: synth["model_params"][k] for k in widths})
    aept.update(train_max_steps=2, save_interval_steps=1, eval_interval_steps=0,
                log_interval_steps=1, batch_size=4)
    overlay = tmp_path / "aept.yaml"
    overlay.write_text(yaml.safe_dump(aept))
    out = tmp_path / "aept"
    trainer = vc_train.main(
        [a for k in ("src-train", "src-dev", "trg-train", "trg-dev")
         for a in (f"--{k}-dumpdir", str(scp))]
        + ["--init-checkpoint", str(tts_ckpt), "--config", SYNTH, "--additional-config",
           str(overlay), "--outdir", str(out), "--device", "cpu"])

    # the effective config: the JAX merge of the same files (the CLI's own
    # arguments and the version aside)
    cfg = yaml.safe_load((out / "config.yml").read_text())
    want = jax_merge_args(synth, None, str(overlay))
    args = {"src_train_dumpdir", "src_dev_dumpdir", "trg_train_dumpdir", "trg_dev_dumpdir",
            "trg_stats", "src_feat_type", "trg_feat_type", "train_dp_input_dir",
            "dev_dp_input_dir", "train_duration_dir", "dev_duration_dir", "outdir", "config",
            "additional_config", "init_checkpoint", "resume", "device", "verbose", "version"}
    assert {k: v for k, v in cfg.items() if k not in args} == want
    assert cfg["use_guided_attn_loss"] and cfg["model_type"] == "VTN"
    assert cfg["inference"] == synth["inference"] and cfg["trainer_type"] == "ARVCTrainer"

    hist = [h for h in trainer.history if "train/loss" in h]
    assert len(hist) == 2 and all(h["train/guided_attn_loss"] > 0 for h in hist)
    src = torch.load(tts_ckpt, weights_only=True)["model"]
    first, last = (torch.load(out / f"checkpoint-{n}steps.pt", weights_only=True)["model"]
                   for n in (1, 2))
    torch.manual_seed(0)  # vc_train's init, before the transfer
    init = VTN(**cfg["model_params"]).state_dict()
    groups = module_keys(trainer.model)
    for mod in AEPT_MODS:  # transferred, then frozen
        for k in groups[mod]:
            assert torch.equal(first[k], src[k]) and torch.equal(last[k], src[k]), k
    for mod in ("dprenet", "dprenet_proj", "encoder"):  # not transferred, and trained
        assert any(not torch.equal(init[k], last[k]) for k in groups[mod]), mod
        assert any(not torch.equal(first[k], last[k]) for k in groups[mod]), mod
    assert not any(torch.equal(init[k], src[k]) for k in groups["dprenet"])
    assert {n for n, p in trainer.model.named_parameters() if not p.requires_grad} == {
        k for m in AEPT_MODS for k in groups[m]}
