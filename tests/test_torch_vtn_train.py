"""Port: the VTN training step (seq2seq_vc_torch/train/ar_vc.py,
losses/seq2seq.py, train/data.py's ``ARVCCollater`` and the teacher-forced
forward) against the JAX package.

The tiny VTN of ``tests/_torch_port.py`` with every dropout rate 0 takes
one ``ARVCTrainer`` step in the JAX package (its dense attention, the loss
function run deterministic, since the JAX VTN has no postnet dropout
switch) and in the port (train() mode, the postnet's dropout set to 0)
from the same weights and batch. The flash route is held without a JAX
trainer step in interpret mode: one ``MultiHeadedAttention`` layer against
the JAX layer's flash route (gate lowered, Pallas in interpret mode), then
the port's whole step on the flash route against its own step on the dense
route.

Tolerances (float32): loss terms rtol 1e-5; each gradient tensor within
1e-4 of its largest magnitude, the ``linear_k`` biases (true gradient 0, as
a softmax does not see a constant added to every key score) to rounding
noise: atol 1e-7 against JAX's dense route, under 1e-6 of the largest
gradient on the flash route; parameters after one clipped Adam step (lr
1e-3) atol 1e-5, as tests/test_torch_train.py holds them. The collater bit
for bit; the loss against JAX rtol 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import release_jax_executables, vtn_pair  # noqa: F401 (autouse fixture)
from seq2seq_vc_tpu.losses import get_criterion as jax_criterion
from seq2seq_vc_tpu.nn.attention import MultiHeadedAttention as JaxMHA
from seq2seq_vc_tpu.train.ar_vc import ARVCTrainer as JaxARVCTrainer
from seq2seq_vc_tpu.train.data import ARVCCollater as JaxCollater
from seq2seq_vc_tpu.train.optim import build_optimizer as jax_build_optimizer
from seq2seq_vc_tpu.train.state import TrainState as JaxTrainState
from seq2seq_vc_torch.convert import vtn_state_dict
from seq2seq_vc_torch.losses import GuidedMultiHeadAttentionLoss, get_criterion
from seq2seq_vc_torch.nn import attention
from seq2seq_vc_torch.nn.attention import MultiHeadedAttention
from seq2seq_vc_torch.train.ar_vc import ARVCTrainer
from seq2seq_vc_torch.train.data import ARVCCollater, DataLoader, ParallelVCMelDataset
from seq2seq_vc_torch.train.optim import build_optimizer
from seq2seq_vc_torch.train.state import TrainState

NO_DROPOUT = dict(
    transformer_enc_dropout_rate=0.0, transformer_enc_positional_dropout_rate=0.0,
    transformer_enc_attn_dropout_rate=0.0, transformer_dec_dropout_rate=0.0,
    transformer_dec_positional_dropout_rate=0.0, transformer_dec_attn_dropout_rate=0.0,
)
OPT = dict(optimizer_params={"lr": 1e-3}, scheduler_params={"warmup_steps": 10}, grad_norm=1.0)
CONFIG = dict(train_max_steps=1, log_interval_steps=1, seed=0)
TERMS = ("l1_loss", "bce_loss")
NOISE = 1e-6  # of the largest gradient: the linear_k biases, true gradient 0


def _items(seed=0, lens=((44, 37), (48, 40), (31, 29))):
    rng = np.random.default_rng(seed)
    return [{"utt_id": f"u{i}", "src_feat": rng.standard_normal((s, 80)).astype(np.float32),
             "trg_feat": rng.standard_normal((t, 80)).astype(np.float32)}
            for i, (s, t) in enumerate(lens)]


def _batch():
    return ARVCCollater(pad_multiple=16, reduction_factor=4)(_items())


def _criterion():
    return {"Seq2SeqLoss": get_criterion("Seq2SeqLoss", bce_pos_weight=10.0)}


def test_collater_matches_jax():
    items = _items(1, lens=((50, 23), (17, 41), (33, 36)))
    got = ARVCCollater(32, 3)(items)
    want = JaxCollater(32, 3)(items)
    assert set(got) == set(want) and got["ys"].shape[1] == 96  # lcm(32, 3)
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert got["labels"][1, 40] == 1 and got["labels"][1, 39] == 0  # 1 from olen - 1 on


def test_seq2seq_loss_matches_jax():
    rng = np.random.default_rng(2)
    after, before, ys = (rng.standard_normal((3, 24, 80)).astype(np.float32) for _ in range(3))
    logits = 3 * rng.standard_normal((3, 24)).astype(np.float32)
    olens = np.array([24, 17, 5])
    labels = (np.arange(24)[None, :] >= olens[:, None] - 1).astype(np.float32)
    want = jax_criterion("Seq2SeqLoss", bce_pos_weight=10.0)(after, before, logits, ys, labels,
                                                             olens)
    got = _criterion()["Seq2SeqLoss"](*map(torch.from_numpy, (after, before, logits, ys, labels,
                                                              olens)))
    for name, g, w in zip(TERMS, got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6, err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_step():
    """The JAX trainer's step: (loss terms, gradient tree, updated params)."""
    _, jax_model, flax = vtn_pair(seed=0, **NO_DROPOUT)
    tx, _ = jax_build_optimizer(**OPT)
    trainer = JaxARVCTrainer(jax_model, JaxTrainState.create(flax, tx),
                             {"Seq2SeqLoss": jax_criterion("Seq2SeqLoss", bce_pos_weight=10.0)},
                             dict(CONFIG), [], mesh=None, writer=False)
    arrays = trainer._array_batch(_batch())
    rngs = {"dropout": jax.random.PRNGKey(0)}
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: trainer.loss_fn(p, arrays, rngs, trainer._flags(), deterministic=True),
        has_aux=True))(flax)
    new = trainer.state.apply_gradients(grads).params
    return {k: float(v) for k, v in metrics.items()}, grads, new


@functools.lru_cache(maxsize=None)
def _port_step(backend="xla"):
    port, _, _ = vtn_pair(seed=0, port_kw=dict(attention_backend=backend, flash_min_len=1),
                          **NO_DROPOUT)
    port.postnet.dropout_rate = 0.0
    state = TrainState(port, build_optimizer(port.parameters(), **OPT))
    trainer = ARVCTrainer(state, _criterion(), dict(CONFIG), [], device="cpu")
    trainer.model.train()
    loss, metrics = trainer.loss_fn(trainer._array_batch(_batch()), trainer._flags(),
                                    trainer.generator)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in trainer.model.named_parameters()}
    trainer.state.apply_gradients()
    new = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    return {k: v.item() for k, v in metrics.items()}, grads, new, trainer.model


def test_step_loss_terms_match_jax():
    want, got = _jax_step()[0], _port_step()[0]
    for name in TERMS:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, err_msg=name)


def test_step_gradients_match_jax():
    _, grads, _, model = _port_step()
    want = vtn_state_dict(_jax_step()[1], model)
    assert set(want) == set(grads)
    n_attention = 0
    for name, w in want.items():
        g, w = grads[name].numpy(), w.numpy()
        if name.endswith("linear_k.bias"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-7, err_msg=name)
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=name)
        if "_attn.linear_" in name and name.endswith("weight"):
            assert np.abs(g).max() > 0, name
            n_attention += 1
    assert n_attention == 4 * (2 + 2 * 2)  # q, k, v, out: 2 encoder, 2 x 2 decoder attentions


def test_step_updated_parameters_match_jax():
    _, _, new, model = _port_step()
    for name, w in vtn_state_dict(_jax_step()[2], model).items():
        np.testing.assert_allclose(new[name].numpy(), w.numpy(), rtol=0, atol=1e-5, err_msg=name)


def test_attention_layer_on_the_flash_route_matches_jax():
    B, T, F, H = 2, 40, 32, 2
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.array([T, 23])[:, None])[:, None, :]
    g = rng.standard_normal((B, T, F)).astype(np.float32)
    jax_att = JaxMHA(H, F, backend="flash", flash_train_min_len=0)
    params = jax_att.init(jax.random.PRNGKey(0), x, x, x, mask)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)

    def loss(p):
        out = jax_att.apply(p, x, x, x, mask, deterministic=False)
        return jnp.sum(out * g), out

    (_, want_out), want = jax.value_and_grad(loss, has_aux=True)(params)
    port = MultiHeadedAttention(H, F, backend="flash", flash_min_len=0)
    want = vtn_state_dict(want, port)
    port.load_state_dict(vtn_state_dict(params, port))
    port.train()
    assert port.route(T, torch.from_numpy(mask)) == "flash"
    xt = torch.from_numpy(x)
    out = port(xt, xt, xt, torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=2e-5, rtol=0)
    (out * torch.from_numpy(g)).sum().backward()
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in port.named_parameters():
        w = want[name].numpy()
        if name == "linear_k.bias":  # rounding noise on both sides
            assert max(np.abs(w).max(), p.grad.abs().max().item()) < NOISE * top
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_step_on_the_flash_route_matches_the_dense_route(monkeypatch):
    calls = {"flash": 0}
    flash = attention.flash_attention

    def spy(*a, **kw):
        calls["flash"] += 1
        return flash(*a, **kw)

    monkeypatch.setattr(attention, "flash_attention", spy)
    metrics, grads, new, model = _port_step.__wrapped__("flash")
    assert calls["flash"] == 2  # the encoder's two layers; the decoder stays dense
    want_metrics, want_grads, want_new, _ = _port_step("xla")
    for name in TERMS:
        np.testing.assert_allclose(metrics[name], want_metrics[name], rtol=1e-5, err_msg=name)
    top = max(float(w.abs().max()) for w in want_grads.values())
    for name, w in want_grads.items():
        g, w = grads[name].numpy(), w.numpy()
        if name.endswith("linear_k.bias"):
            assert max(np.abs(g).max(), np.abs(w).max()) < NOISE * top, name
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=name)
    for name, w in want_new.items():
        np.testing.assert_allclose(new[name].numpy(), w.numpy(), rtol=0, atol=1e-5, err_msg=name)


def test_trainer_runs_on_a_corpus_read_through_the_loader(tmp_path):
    scp = {"src_feat": [], "trg_feat": []}
    for item in _items(3, lens=((40, 36), (33, 30), (48, 45), (21, 25))):
        for key in scp:
            path = tmp_path / f"{key}_{item['utt_id']}.npy"
            np.save(path, item[key])
            scp[key].append(f"{item['utt_id']} {path}")
    for key, lines in scp.items():
        (tmp_path / f"{key}.scp").write_text("\n".join(lines) + "\n")
    dataset = ParallelVCMelDataset(str(tmp_path / "src_feat.scp"), str(tmp_path / "trg_feat.scp"))
    loader = DataLoader(dataset, ARVCCollater(16, 4), batch_size=2, seed=0, prefetch=0)
    port, _, _ = vtn_pair(seed=1)
    state = TrainState(port, build_optimizer(port.parameters(), **OPT))
    trainer = ARVCTrainer(state, _criterion(), dict(CONFIG, train_max_steps=3), loader,
                          device="cpu")
    trainer.run()
    assert trainer.steps == 3 and len(trainer.history) == 3
    assert all(np.isfinite(h["train/loss"]) and h["train/bce_loss"] > 0 for h in trainer.history)
    # with use_guided_attn_loss and the criterion, one more step adds the term
    guided = ARVCTrainer(state, dict(_criterion(), guided_attn=GuidedMultiHeadAttentionLoss()),
                         dict(CONFIG, train_max_steps=4, use_guided_attn_loss=True), loader,
                         device="cpu")
    guided.run()
    assert guided.steps == 4 and guided.history[-1]["train/guided_attn_loss"] > 0


def test_evaluate_gives_the_same_dev_loss_twice():
    """The prenet's always-on dropout (rate 0.5) draws from the step's
    generator, which ``evaluate`` seeds afresh for each dev batch: two
    evaluations of the same weights give the same dev loss, and a
    different generator gives a different one."""
    port, _, _ = vtn_pair(seed=2, dprenet_dropout_rate=0.5)
    state = TrainState(port, build_optimizer(port.parameters(), **OPT))
    trainer = ARVCTrainer(state, _criterion(), dict(CONFIG), [], dev_loader=[_batch()],
                          device="cpu")
    first, second = trainer.evaluate(), trainer.evaluate()
    assert first == second and np.isfinite(first["loss"])
    trainer.model.eval()
    with torch.no_grad():
        batch = trainer._array_batch(_batch())
        other = trainer.loss_fn(batch, trainer._flags(), torch.Generator().manual_seed(7))[0]
    assert float(other) != first["loss"]
