"""Port: the AAS-VC training step (seq2seq_vc_torch/train, losses,
ops/forward_sum.py, and the model's training forward).

The tiny AAS-VC of ``tests/_torch_port.py`` with every dropout rate 0 takes
one ``AASVCTrainer`` step in the JAX package and in the port from the same
weights and batch, with the stochastic duration predictor's ``e_q`` given
to both (on the JAX side by ``flax.linen.intercept_methods``, on the port's
by wrapping ``nll``). The JAX model uses the dense ``xla`` attention and
the ``direct`` alignment distance; the port runs its ``xla`` attention and
the fused Function with each backward variant on the CPU.

Tolerances (float32): loss terms rtol 1e-5; each gradient tensor within
1e-4 of its largest magnitude (measured: under 1e-5), except the
``linear_k`` biases, whose true gradient is 0 (a softmax does not see a
constant added to every key score): atol 1e-7 there, as the two sides
return different rounding noise; parameters after one clipped Adam step
(lr 1e-4) atol 1e-5 (a sign flip of a gradient would move one by 2e-4).
The forward-sum loss rtol 1e-5, its gradient atol 1e-6; the optimizer
against optax atol 1e-6 (a few float32 ulps of parameters near 2).
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import aasvc_pair, release_jax_executables  # noqa: F401 (autouse fixture)
from seq2seq_vc_tpu.losses import get_criterion as jax_criterion
from seq2seq_vc_tpu.nn.flows import StochasticDurationPredictor as JaxSDP
from seq2seq_vc_tpu.ops.forward_sum import beta_binomial_prior as jax_prior
from seq2seq_vc_tpu.ops.forward_sum import forward_sum_loss as jax_forward_sum
from seq2seq_vc_tpu.train.aas_vc import AASVCTrainer as JaxAASVCTrainer
from seq2seq_vc_tpu.train.data import DataLoader as JaxDataLoader
from seq2seq_vc_tpu.train.data import NARVCCollater as JaxCollater
from seq2seq_vc_tpu.train.data import ParallelVCMelDataset as JaxDataset
from seq2seq_vc_tpu.train.optim import build_optimizer as jax_build_optimizer
from seq2seq_vc_tpu.train.schedulers import warmup_lr_schedule as jax_warmup
from seq2seq_vc_tpu.train.state import TrainState as JaxTrainState
from seq2seq_vc_torch.convert import aasvc_state_dict
from seq2seq_vc_torch.losses import get_criterion
from seq2seq_vc_torch.nn import alignment
from seq2seq_vc_torch.nn.attention import FLASH_MIN_LEN
from seq2seq_vc_torch.ops.forward_sum import beta_binomial_prior, forward_sum_loss
from seq2seq_vc_torch.train import data
from seq2seq_vc_torch.train.aas_vc import AASVCTrainer
from seq2seq_vc_torch.train.optim import Optimizer, build_optimizer
from seq2seq_vc_torch.train.schedulers import warmup_lr_schedule
from seq2seq_vc_torch.train.state import TrainState

NO_DROPOUT = dict(
    transformer_enc_dropout_rate=0.0, transformer_enc_positional_dropout_rate=0.0,
    transformer_enc_attn_dropout_rate=0.0, transformer_dec_dropout_rate=0.0,
    transformer_dec_positional_dropout_rate=0.0, transformer_dec_attn_dropout_rate=0.0,
    postnet_dropout_rate=0.0, stochastic_duration_predictor_dropout_rate=0.0,
)
OPT = dict(optimizer_params={"lr": 1e-3}, scheduler_params={"warmup_steps": 10}, grad_norm=1.0)
CONFIG = dict(train_max_steps=1, log_interval_steps=1, lambda_align=2.0,
              dp_train_start_steps=0, seed=0)
TERMS = ("l1_loss", "forward_sum_loss", "binary_loss", "duration_loss")
PORT_ROUTES = [("xla", "auto"), ("fused", "xla"), ("fused", "banded")]


def _batch(seed=0, B=2):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((B, 48, 80)).astype(np.float32)
    ys = rng.standard_normal((B, 64, 80)).astype(np.float32)
    ilens = np.array([48, 36], np.int32)
    return dict(xs=xs, ilens=ilens, ys=ys, olens=np.array([64, 50], np.int32),
                dp_inputs=xs, dplens=ilens, utt_ids=["a", "b"])


def _noise(seed=1):
    return np.random.default_rng(seed).standard_normal((2, 12, 2)).astype(np.float32)


def _inject_jax_noise(noise):
    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, JaxSDP) and context.method_name == "__call__":
            kwargs = dict(kwargs, noise=jnp.asarray(noise))
        return next_fun(*args, **kwargs)

    return fnn.intercept_methods(interceptor)


def _inject_port_noise(model, noise):
    nll = model.duration_predictor.nll
    model.duration_predictor.nll = lambda x, m, w, *_, **__: nll(x, m, w, torch.from_numpy(noise))


@functools.lru_cache(maxsize=None)
def _jax_step():
    """The JAX trainer's step: (loss terms, gradient tree, updated params)."""
    _, jax_model, flax = aasvc_pair(seed=0, **NO_DROPOUT)
    tx, _ = jax_build_optimizer(**OPT)
    trainer = JaxAASVCTrainer(jax_model, JaxTrainState.create(flax, tx),
                              {"L1Loss": jax_criterion("L1Loss")}, dict(CONFIG), [],
                              mesh=None, writer=False)
    arrays = trainer._array_batch(_batch())
    rngs = {"dropout": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    with _inject_jax_noise(_noise()):
        (_, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: trainer.loss_fn(p, arrays, rngs, trainer._flags()), has_aux=True
        ))(flax)
    new = trainer.state.apply_gradients(grads).params
    return {k: float(v) for k, v in metrics.items()}, grads, new


def _port_trainer(backend="xla", bwd="auto", seed=0, config=None, loader=(),
                  flash_min_len=FLASH_MIN_LEN, **over):
    port_kw = dict(attention_backend=backend, rel_scores_bwd=bwd, flash_min_len=flash_min_len)
    port, _, _ = aasvc_pair(seed=seed, port_kw=port_kw, **dict(NO_DROPOUT, **over))
    state = TrainState(port, build_optimizer(port.parameters(), **OPT))
    return AASVCTrainer(state, {"L1Loss": get_criterion("L1Loss")}, dict(CONFIG, **(config or {})),
                        loader, device="cpu")


@functools.lru_cache(maxsize=None)
def _port_step(backend, bwd, flash_min_len=FLASH_MIN_LEN):
    trainer = _port_trainer(backend, bwd, flash_min_len=flash_min_len)
    _inject_port_noise(trainer.model, _noise())
    trainer.model.train()
    loss, metrics = trainer.loss_fn(trainer._array_batch(_batch()), trainer._flags(),
                                    trainer.generator)
    loss.backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
             for k, p in trainer.model.named_parameters()}
    trainer.state.apply_gradients()
    new = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    return {k: v.item() for k, v in metrics.items()}, grads, new, trainer.model


@pytest.mark.parametrize("backend,bwd", PORT_ROUTES)
def test_step_loss_terms_match_jax(backend, bwd):
    want = _jax_step()[0]
    got = _port_step(backend, bwd)[0]
    for name in TERMS:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("backend,bwd", PORT_ROUTES)
def test_step_gradients_match_jax(backend, bwd):
    _, grads, _, model = _port_step(backend, bwd)
    want = aasvc_state_dict(_jax_step()[1], model)
    assert set(want) == set(grads)
    n_attention = 0
    for name, w in want.items():
        g, w = grads[name].numpy(), w.numpy()
        if name.endswith("linear_k.bias"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-7, err_msg=name)
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=name)
        if ".self_attn.linear_" in name and name.endswith("weight"):
            assert np.abs(g).max() > 0, name
            n_attention += 1
    assert n_attention == 2 * 5  # q, k, v, out, pos in the encoder and the decoder


@pytest.mark.parametrize("backend,bwd", PORT_ROUTES)
def test_step_updated_parameters_match_jax(backend, bwd):
    _, _, new, model = _port_step(backend, bwd)
    want = aasvc_state_dict(_jax_step()[2], model)
    for name, w in want.items():
        np.testing.assert_allclose(new[name].numpy(), w.numpy(), rtol=0, atol=1e-5, err_msg=name)


def test_forward_sum_loss_and_its_gradient_quirk_match_jax():
    rng = np.random.default_rng(3)
    B, t_feats, t_text = 3, 40, 11
    ilens, olens = np.array([11, 7, 9]), np.array([40, 25, 8])  # item 2 cannot align: inf
    scores = rng.standard_normal((B, t_feats, t_text)).astype(np.float32)
    scores[1, :, 7:] = -np.inf
    lp = torch.log_softmax(torch.from_numpy(scores), -1).numpy()
    prior = beta_binomial_prior(ilens, olens, t_text, t_feats)
    np.testing.assert_array_equal(prior, jax_prior(ilens, olens, t_text, t_feats))

    x = torch.from_numpy(lp).requires_grad_()
    loss = forward_sum_loss(x + torch.from_numpy(prior), torch.from_numpy(ilens),
                            torch.from_numpy(olens))
    loss.backward()
    want, want_grad = jax.value_and_grad(
        lambda a: jax_forward_sum(a + prior, ilens, olens, grad_semantics="torch")
    )(jnp.asarray(lp))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=0, atol=1e-6)
    # host lengths give the same loss, and so does the criterion that adds the prior
    host = forward_sum_loss(x.detach() + torch.from_numpy(prior), ilens.tolist(), olens.tolist())
    assert host.item() == loss.item()
    wrapped = get_criterion("ForwardSumLoss")(x.detach(), torch.from_numpy(ilens),
                                              torch.from_numpy(olens))
    assert wrapped.item() == loss.item()


@pytest.mark.parametrize("count", [0, 1, 2, 5, 3999, 4000, 4001, 10 ** 5])
def test_warmuplr_matches_jax(count):
    got = warmup_lr_schedule(8e-5, 4000)(count)
    np.testing.assert_allclose(got, float(jax_warmup(8e-5, 4000)(jnp.asarray(count))), rtol=1e-6)


@pytest.mark.parametrize("accumulate", [1, 2])
@pytest.mark.parametrize("grad_scale", [0.5, 3.0])  # global norm under and over the limit
def test_optimizer_matches_optax(accumulate, grad_scale):
    rng = np.random.default_rng(4)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2,))]
    micro = [[grad_scale * rng.standard_normal(p.shape).astype(np.float32) / 3 for p in p0[:2]]
             for _ in range(accumulate)]  # the last parameter gets no gradient
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = build_optimizer(params, optimizer_params={"lr": 1e-2},
                          scheduler_params={"warmup_steps": 3}, grad_norm=1.0,
                          gradient_accumulate_steps=accumulate)
    tx, _ = jax_build_optimizer(optimizer_params={"lr": 1e-2}, scheduler_params={"warmup_steps": 3},
                                grad_norm=1.0, gradient_accumulate_steps=accumulate)
    jp = [jnp.asarray(p) for p in p0]
    js = tx.init(jp)
    for _ in range(2):  # two optimizer steps
        for grads in micro:
            for p, g in zip(params, grads):
                g = torch.from_numpy(g)
                p.grad = g.clone() if p.grad is None else p.grad + g
            upd, js = tx.update([jnp.asarray(g) for g in grads] + [jnp.zeros(2)], js, jp)
            jp = optax.apply_updates(jp, upd)
        norm = opt.step()
        assert all(p.grad is None for p in params)
        if grad_scale > 1:
            assert norm.item() > 1.0
    assert opt.count == 2
    for p, w in zip(params, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_optimizer_refuses_what_is_not_ported():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="freeze_mods needs the model"):
        build_optimizer(p, freeze_mods=["encoder"])
    with pytest.raises(NotImplementedError, match="SGD"):
        build_optimizer(p, optimizer_type="SGD")
    assert isinstance(build_optimizer(p), Optimizer)


def _write_corpus(root, lens, seed=0, fmt="npy"):
    """A parallel corpus of random mel features: scp files for src and trg."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    scps = {}
    for side in ("src", "trg"):
        lines = []
        for i, (n_src, n_trg) in enumerate(lens):
            n = n_src if side == "src" else n_trg
            feat = rng.standard_normal((n, 80)).astype(np.float32)
            if fmt == "npy":
                path = root / f"{side}_{i:03d}.npy"
                np.save(path, feat)
            else:
                import h5py

                path = root / f"{side}_{i:03d}.h5"
                with h5py.File(path, "w") as f:
                    f.create_dataset("feats", data=feat)
            lines.append(f"utt{i:03d} {path}")
        scps[side] = root / f"{side}.scp"
        scps[side].write_text("\n".join(lines) + "\n")
    return str(scps["src"]), str(scps["trg"])


LENS = [(37, 45), (48, 61), (20, 33), (44, 40), (29, 52)]


@pytest.mark.parametrize("fmt", ["npy", "h5"])
def test_collater_and_loader_batches_match_jax(tmp_path, fmt):
    src, trg = _write_corpus(tmp_path, LENS, fmt=fmt)
    kw = dict(pad_multiple=8, post_encoder_reduction_factor=4)
    port = data.DataLoader(data.ParallelVCMelDataset(src, trg, dp_feats=src),
                           data.NARVCCollater(**kw), batch_size=2, seed=3, prefetch=1)
    ref = JaxDataLoader(JaxDataset(src, trg, dp_feats=src), JaxCollater(**kw), batch_size=2,
                        seed=3, prefetch=0, process_index=0, process_count=1)
    for _ in range(2):  # two epochs: the batch order is reshuffled
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    batch = got[0]
    assert batch["xs"].shape[1] % 8 == 0 and batch["ys"].shape[1] % 8 == 0
    for x, n in zip(batch["xs"], batch["ilens"]):
        assert not x[n:].any()  # zero padding past each length


def test_hdf5_needs_h5py_only_when_read(tmp_path, monkeypatch):
    src, trg = _write_corpus(tmp_path, LENS[:2], fmt="h5")
    ds = data.ParallelVCMelDataset(src, trg)
    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    with pytest.raises(ImportError, match="needs h5py"):
        ds[0]
    npy_src, npy_trg = _write_corpus(tmp_path / "npy", LENS[:2])
    assert data.ParallelVCMelDataset(npy_src, npy_trg)[1]["src_feat"].shape == (48, 80)


def test_dropout_is_active_in_train_and_off_in_eval():
    port, _, _ = aasvc_pair(seed=5)  # the JAX defaults: every dropout rate above 0
    b = {k: torch.from_numpy(v) for k, v in _batch().items() if k != "utt_ids"}
    noise = torch.from_numpy(_noise())

    def run():
        out = port(b["xs"], b["ilens"], b["ys"], b["olens"], b["dp_inputs"], noise=noise)
        return out["after_outs"].detach(), out["dur_nll"].detach()

    port.train()
    torch.manual_seed(0)
    a, b_ = run(), run()
    assert not torch.equal(a[0], b_[0]) and not torch.equal(a[1], b_[1])
    port.eval()
    c, d = run(), run()
    assert torch.equal(c[0], d[0]) and torch.equal(c[1], d[1])
    # train() with every rate at 0 is the eval() forward
    for m in port.modules():
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0
    port.train()
    e = run()
    torch.testing.assert_close(e[0], c[0], rtol=0, atol=0)


def test_trainer_runs_evaluates_saves_and_resumes(tmp_path):
    src, trg = _write_corpus(tmp_path / "corpus", LENS)
    loader = data.DataLoader(data.ParallelVCMelDataset(src, trg, dp_feats=src),
                             data.NARVCCollater(pad_multiple=8, post_encoder_reduction_factor=4),
                             batch_size=2, seed=0)
    config = dict(train_max_steps=3, log_interval_steps=1, eval_interval_steps=3,
                  save_interval_steps=3, outdir=str(tmp_path / "exp"))
    trainer = _port_trainer(config=config, loader=loader)
    trainer.dev_loader = loader
    trainer.run()
    assert trainer.steps == 3 and trainer.state.optimizer.count == 3
    train_logs = [h for h in trainer.history if "train/loss" in h]
    assert [h["steps"] for h in train_logs] == [1, 2, 3]
    assert all(np.isfinite(h["train/loss"]) and h["train/grad_norm"] > 0 for h in train_logs)
    dev = [h for h in trainer.history if "dev/loss" in h]
    assert len(dev) == 1 and np.isfinite(dev[0]["dev/loss"])
    assert trainer.model.training  # eval restored train mode

    resumed = _port_trainer(seed=9, config=dict(config, train_max_steps=4), loader=loader)
    resumed.load_checkpoint(str(tmp_path / "exp" / "checkpoint-3steps.pt"))
    assert resumed.steps == 3
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    a = trainer.state.optimizer.adam.state_dict()["state"]
    b = resumed.state.optimizer.adam.state_dict()["state"]
    assert all(torch.equal(a[i]["exp_avg_sq"], b[i]["exp_avg_sq"]) for i in a)
    resumed.run()
    assert resumed.steps == 4


def test_dp_loss_waits_for_dp_train_start_steps():
    trainer = _port_trainer(config=dict(dp_train_start_steps=1))
    _inject_port_noise(trainer.model, _noise())
    loss, metrics = trainer.loss_fn(trainer._array_batch(_batch()), trainer._flags(),
                                    trainer.generator)
    assert "duration_loss" not in metrics
    want = metrics["l1_loss"] + 2.0 * (metrics["forward_sum_loss"] + metrics["binary_loss"])
    torch.testing.assert_close(loss, want)
    loss.backward()
    assert trainer.model.duration_predictor.post_pre.weight.grad is None


def test_alignment_distance_in_checkpointed_blocks_matches_one_pass(monkeypatch):
    rng = np.random.default_rng(7)
    f0, t0, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((2, 23, 6), (2, 9, 6), (2, 23, 9)))

    def run():
        f, t = f0.clone().requires_grad_(), t0.clone().requires_grad_()
        d = alignment.pairwise_sq_dist(f, t)
        d.backward(g)
        return d.detach(), f.grad, t.grad

    one_pass = run()
    monkeypatch.setattr(alignment, "DIST_BLOCK_ELEMS", 2 * 5 * 9 * 6)  # blocks of 5 frames
    blocks = run()
    # each distance is the same sum; t's gradient adds the blocks' parts in another order
    torch.testing.assert_close(blocks[0], one_pass[0], rtol=0, atol=0)
    for a, b in zip(blocks[1:], one_pass[1:]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-5)
