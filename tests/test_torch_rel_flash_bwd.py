"""Port: rel-pos flash attention with dropout, its logsumexp and its
backward (seq2seq_vc_torch/ops/flash_attention.py, the flash route of
seq2seq_vc_torch/nn/attention.py), against the JAX package.

The JAX side runs as its own tests run it on the CPU: the Pallas kernels in
interpret mode with the default block of 128, so the dropout index runs over
the same padded length. Inputs come from a numpy seed, on ragged T (37, 130)
with key-length padding and a fully masked batch row.

Tolerances (float32): the mask bit for bit; outputs, logsumexps and the
five input gradients atol 2e-5 and rtol 1e-5 (softmax-weighted sums of at
most T = 130 products of unit-variance numbers, taken in another order;
measured under 2e-6). The attention module's and the tiny trainer's
parameter gradients as tests/test_torch_train.py holds them: each tensor
within 1e-4 of its largest magnitude, the ``linear_k`` biases (true
gradient 0) atol 1e-7, parameters after one Adam step atol 1e-5. The single
layer's inputs are larger (largest gradient ~30): its ``linear_k`` bias is
held on both sides to rounding noise, under 1e-6 of the largest gradient
(measured: 2e-7).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import release_jax_executables  # noqa: F401 (autouse fixture)
from seq2seq_vc_tpu.nn.attention import RelPositionMultiHeadedAttention as JaxRelMHA
from seq2seq_vc_tpu.ops import flash_attention as jax_flash
from seq2seq_vc_torch.convert import aasvc_state_dict
from seq2seq_vc_torch.nn import attention
from seq2seq_vc_torch.nn.attention import RelPositionMultiHeadedAttention
from seq2seq_vc_torch.nn.positional_encoding import relative_pe
from seq2seq_vc_torch.ops import flash_attention as port_flash
from test_torch_train import TERMS, _jax_step, _port_step

TOL = dict(atol=2e-5, rtol=1e-5)
NAMES = ("q_u", "q_v", "k", "v", "pos")
SEED = 1234
NOISE = 1e-6  # of the layer's largest gradient: the linear_k bias, true gradient 0


def _inputs(T, D=16, B=3, H=2, seed=0):
    rng = np.random.default_rng(seed)
    qu, qv, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(4))
    pos = rng.standard_normal((H, 2 * T - 1, D)).astype(np.float32)
    lens = np.array([T, T // 2 + 1, 0][:B], np.int32)  # full, padded, fully masked
    g = rng.standard_normal((B, H, T, D)).astype(np.float32)
    return (qu, qv, k, v, pos), lens, g


def _jax_seed(rate):
    return jnp.asarray([SEED], jnp.int32) if rate > 0 else None


@functools.lru_cache(maxsize=None)
def _jax_fwd_with_lse(T, rate):
    """The JAX forward kernel's own (out, lse), through its custom-VJP
    forward rule, with the inputs padded as its entry pads them."""
    (qu, qv, k, v, pos), lens, _ = _inputs(T)
    B, H, _, D = qu.shape
    t_pad, d_pad = jax_flash._round_up(T, 128), jax_flash._round_up(D, 128)

    def padq(x):
        return jnp.pad(x, ((0, 0), (0, 0), (0, t_pad - T), (0, d_pad - D))).reshape(
            B * H, t_pad, d_pad)

    table = jnp.zeros((H, 3 * t_pad, d_pad), jnp.float32)
    table = jax.lax.dynamic_update_slice(
        table, jnp.pad(jnp.asarray(pos), ((0, 0), (0, 0), (0, d_pad - D))), (0, 2 * t_pad - T, 0))
    core = jax_flash._rel_core(H, 128, 1.0 / math.sqrt(D), rate, True)
    seed = jnp.asarray([SEED if rate > 0 else 0], jnp.int32)
    out, res = jax.jit(core.fwd)(jnp.asarray(lens), seed, *map(padq, (qu, qv, k, v)), table)
    out = np.asarray(out).reshape(B, H, t_pad, d_pad)[:, :, :T, :D]
    return out, np.asarray(res[-1])[:, :T, 0].reshape(B, H, T)


@functools.lru_cache(maxsize=None)
def _jax_vjp(T, rate):
    """(out, the five input cotangents) of the JAX entry for the seeded g."""
    arrays, lens, g = _inputs(T)
    out, vjp = jax.vjp(
        lambda *a: jax_flash.rel_flash_attention(
            *a, kv_lens=jnp.asarray(lens), dropout_rate=rate, dropout_seed=_jax_seed(rate)),
        *map(jnp.asarray, arrays))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


# (a) the dropout mask
@pytest.mark.parametrize("seed", [0, 1, 77, 2**31 - 2])
def test_dropout_keep_mask_is_jax_bit_for_bit(seed):
    want = np.asarray(jax_flash.dense_dropout_keep(jnp.int32(seed), 6, 256, 128, 0.2))
    got = port_flash.dense_dropout_keep(seed, 6, 256, 128, 0.2).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.75 < got.mean() < 0.85


def test_dropout_index_wraps_past_two_to_the_31_as_jax():
    # bh 2 at t_pad 40000: the index passes 2^31, where JAX's int32 wraps
    want = np.asarray(jax_flash._keep_block(jnp.int32(5), 2, 39990, 39000, (10, 64), 0.3,
                                            40000, 40000))
    got = port_flash.keep_mask(5, torch.tensor(2), torch.arange(39990, 40000)[:, None],
                               torch.arange(39000, 39064)[None, :], 40000, 40000, 0.3)
    np.testing.assert_array_equal(got.numpy(), want)
    idx = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    np.testing.assert_array_equal(
        port_flash.mix_bits(torch.from_numpy(idx.astype(np.int64)), 2**31 - 2).numpy(),
        np.asarray(jax_flash._mix_bits(jnp.asarray(idx), jnp.int32(2**31 - 2))))


# (b) the forward with dropout and its logsumexp
@pytest.mark.parametrize("T", [37, 130])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_plain_forward_and_lse_match_the_jax_kernel(T, rate):
    arrays, lens, _ = _inputs(T)
    out, lse = port_flash.rel_flash_attention_plain(
        *map(torch.from_numpy, arrays), torch.from_numpy(lens), rate,
        SEED if rate else None, return_lse=True)
    want_out, want_lse = _jax_fwd_with_lse(T, rate)
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)
    assert lse.dtype == torch.float32 and (lse[2] == port_flash.NEG_INF).all()
    assert not out[2].any()  # a row with no keys returns zeros
    np.testing.assert_allclose(out.numpy(), _jax_vjp(T, rate)[0], **TOL)


# (c) the autograd gradients of all five inputs
@pytest.mark.parametrize("T", [37, 130])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_gradients_match_jax_vjp(T, rate):
    arrays, lens, g = _inputs(T)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = port_flash.rel_flash_attention(*ts, kv_lens=torch.from_numpy(lens),
                                         dropout_rate=rate, dropout_seed=SEED if rate else None)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    for name, t, want in zip(NAMES, ts, _jax_vjp(T, rate)[1]):
        np.testing.assert_allclose(t.grad.numpy(), want, err_msg=name, **TOL)
    assert not ts[2].grad[2].any() and not ts[3].grad[2].any()  # no live key, no gradient


def test_backward_kernels_plain_versions_compose_the_whole_backward():
    arrays, lens, g = _inputs(37, seed=3)
    a = [torch.from_numpy(x) for x in arrays]
    lens, g = torch.from_numpy(lens), torch.from_numpy(g)
    out, lse = port_flash.rel_flash_attention_plain(*a, lens, 0.2, 9, return_lse=True)
    whole = port_flash.rel_flash_attention_bwd_plain(*a, lens, out, lse, g, 0.2, 9)
    delta = port_flash._delta(out, g)
    parts = (*port_flash.rel_flash_bwd_dq(*a, lens, lse, delta, g, 0.2, 9),
             *port_flash.rel_flash_bwd_dkv(*a, lens, lse, delta, g, 0.2, 9),
             port_flash.rel_flash_bwd_dpos(*a, lens, lse, delta, g, 0.2, 9))
    for name, x, y in zip(NAMES, parts, whole):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6, msg=name)


# (d) the attention module on the flash route
def test_attention_module_gradients_match_jax_flash_route():
    B, T, F, H = 2, 40, 32, 2
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    pos = relative_pe(T, F).numpy()[None]
    mask = (np.arange(T)[None, :] < np.array([T, 23])[:, None])[:, None, :]
    g = rng.standard_normal((B, T, F)).astype(np.float32)
    jax_att = JaxRelMHA(H, F, backend="flash", flash_train_min_len=0)
    params = jax_att.init(jax.random.PRNGKey(0), x, x, x, pos, mask)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)

    def loss(p):
        out = jax_att.apply(p, x, x, x, pos, mask, deterministic=False)
        return jnp.sum(out * g)

    want = aasvc_state_dict(jax.grad(loss)(params), RelPositionMultiHeadedAttention(H, F))
    port = RelPositionMultiHeadedAttention(H, F, backend="flash", flash_min_len=0)
    port.load_state_dict(aasvc_state_dict(params, port))
    port.train()
    assert port.route(T, T, 2 * T - 1, torch.from_numpy(mask)) == "flash"
    xt = torch.from_numpy(x)
    (port(xt, xt, xt, torch.from_numpy(pos), torch.from_numpy(mask)) * torch.from_numpy(g)).sum().backward()
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in port.named_parameters():
        w = want[name].numpy()
        if name == "linear_k.bias":  # rounding noise on both sides
            assert max(np.abs(w).max(), p.grad.abs().max().item()) < NOISE * top
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
        assert np.abs(p.grad.numpy()).max() > 0, name


# (e) one trainer step with every layer on the flash route
def test_trainer_step_through_the_flash_route_matches_jax(monkeypatch):
    calls = {"flash": 0, "fused": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(attention, "rel_flash_attention",
                        spy("flash", attention.rel_flash_attention))
    monkeypatch.setattr(attention, "fused_rel_scores", spy("fused", attention.fused_rel_scores))
    metrics, grads, new, model = _port_step.__wrapped__("flash", "auto", flash_min_len=1)
    assert calls == {"flash": 2, "fused": 0}  # the encoder's and the decoder's layer
    want_metrics, want_grads, want_new = _jax_step()
    for name in TERMS:
        np.testing.assert_allclose(metrics[name], want_metrics[name], rtol=1e-5, err_msg=name)
    want_grads = aasvc_state_dict(want_grads, model)
    for name, w in want_grads.items():
        g, w = grads[name].numpy(), w.numpy()
        if name.endswith("linear_k.bias"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-7, err_msg=name)
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=name)
    for name, w in aasvc_state_dict(want_new, model).items():
        np.testing.assert_allclose(new[name].numpy(), w.numpy(), rtol=0, atol=1e-5, err_msg=name)
