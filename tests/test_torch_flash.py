"""Port: standard multi-head flash attention (seq2seq_vc_torch/ops/
flash_attention.py: ``flash_attention``, its plain versions and its
backward wrappers) against the JAX package's ``flash_attention``.

The JAX side runs as its own tests run it on the CPU: the Pallas kernels
in interpret mode with the default blocks of 128, so the dropout index runs
over the same padded lengths round_up(Tq, 128) and round_up(Tk, 128).
Inputs come from a numpy seed: self-attention (Tq = Tk = 37) and cross
shapes (Tq 45, Tk 130 and Tq 130, Tk 45; Tq 200, Tk 333 and Tq 333, Tk 200,
which cross several 64-row tiles of the card's backward kernels with
partial last tiles, at the VTN's attention dropout 0.1), head dims 96 (the
VTN's) and 64, key-length padding with a batch row of no key, the causal
mask on and off, rate 0, 0.1 and 0.2.

Tolerances (float32): the keep mask bit for bit; outputs, logsumexps and
the three input gradients atol 2e-5, rtol 1e-5 (softmax-weighted sums of at
most 130 products of unit-variance numbers, taken in another order).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import release_jax_executables  # noqa: F401 (autouse fixture)
from seq2seq_vc_tpu.ops import flash_attention as jax_flash
from seq2seq_vc_torch.ops import flash_attention as port_flash

TOL = dict(atol=2e-5, rtol=1e-5)
SEED = 4321
# (Tq, Tk, D, causal, rate): self-attention and cross shapes
CASES = [(37, 37, 96, False, 0.0), (37, 37, 64, True, 0.2), (45, 130, 96, False, 0.2),
         (130, 45, 64, True, 0.0), (200, 333, 96, True, 0.1), (333, 200, 96, False, 0.1)]


def _inputs(Tq, Tk, D, B=3, H=2, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Tq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, H, Tk, D)).astype(np.float32) for _ in range(2))
    lens = np.array([Tk, Tk // 2 + 1, 0][:B], np.int32)  # full, padded, no key
    g = rng.standard_normal((B, H, Tq, D)).astype(np.float32)
    return (q, k, v), lens, g


def _jax_seed(rate):
    return jnp.asarray([SEED], jnp.int32) if rate > 0 else None


@functools.lru_cache(maxsize=None)
def _jax_fwd_with_lse(Tq, Tk, D, causal, rate):
    """The JAX forward kernel's own (out, lse), through its custom-VJP
    forward rule, with the inputs padded as its entry pads them."""
    (q, k, v), lens, _ = _inputs(Tq, Tk, D)
    B, H = q.shape[:2]
    tq, tk, d_pad = (jax_flash._round_up(n, 128) for n in (Tq, Tk, D))

    def pad(x, t_pad):
        T = x.shape[2]
        return jnp.pad(x, ((0, 0), (0, 0), (0, t_pad - T), (0, d_pad - D))).reshape(
            B * H, t_pad, d_pad)

    core = jax_flash._flash_core(H, 128, 128, 1.0 / math.sqrt(D), causal, rate, True)
    seed = jnp.asarray([SEED if rate > 0 else 0], jnp.int32)
    out, res = jax.jit(core.fwd)(jnp.asarray(lens), seed, pad(q, tq), pad(k, tk), pad(v, tk))
    out = np.asarray(out).reshape(B, H, tq, d_pad)[:, :, :Tq, :D]
    return out, np.asarray(res[-1])[:, :Tq, 0].reshape(B, H, Tq)


@functools.lru_cache(maxsize=None)
def _jax_vjp(Tq, Tk, D, causal, rate):
    """(out, the three input cotangents) of the JAX entry for the seeded g."""
    arrays, lens, g = _inputs(Tq, Tk, D)
    out, vjp = jax.vjp(
        lambda *a: jax_flash.flash_attention(
            *a, kv_lens=jnp.asarray(lens), causal=causal, dropout_rate=rate,
            dropout_seed=_jax_seed(rate)),
        *map(jnp.asarray, arrays))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


# (a) the dropout mask at non-square padded lengths
@pytest.mark.parametrize("seed", [0, 77, 2**31 - 2])
@pytest.mark.parametrize("tq,tk", [(128, 384), (256, 128), (384, 256)])
def test_dropout_keep_mask_at_cross_shapes_is_jax_bit_for_bit(seed, tq, tk):
    want = np.asarray(jax_flash.dense_dropout_keep(jnp.int32(seed), 4, tq, tk, 0.2))
    got = port_flash.dense_dropout_keep(seed, 4, tq, tk, 0.2).numpy()
    np.testing.assert_array_equal(got, want)


def test_plain_dropout_draws_the_cross_shape_mask():
    # (B, H, Tq, Tk) weights of ones: the kept ones are the mask's bits at
    # the padded lengths, element (bh, i, j) at (bh * tq + i) * tk + j
    p = torch.ones(2, 3, 45, 130)
    got = port_flash._dropout(p, 0.3, 9) != 0
    mask = np.asarray(jax_flash.dense_dropout_keep(jnp.int32(9), 6, 128, 256, 0.3))
    np.testing.assert_array_equal(got.reshape(6, 45, 130).numpy(), mask[:, :45, :130])


# (b) the forward with dropout and its logsumexp; CASES[4:6] cross several
# 64-row tiles of the card's forward kernel, one of them causal
@pytest.mark.parametrize("Tq,Tk,D,causal,rate", CASES[1:3] + CASES[4:6])
def test_plain_forward_and_lse_match_the_jax_kernel(Tq, Tk, D, causal, rate):
    arrays, lens, _ = _inputs(Tq, Tk, D)
    out, lse = port_flash.flash_attention_plain(
        *map(torch.from_numpy, arrays), torch.from_numpy(lens), causal, rate,
        SEED if rate else None, return_lse=True)
    want_out, want_lse = _jax_fwd_with_lse(Tq, Tk, D, causal, rate)
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)
    assert lse.dtype == torch.float32 and (lse[2] == port_flash.NEG_INF).all()
    assert not out[2].any()  # a row with no keys returns zeros


# (c) the autograd Function: output and the three input gradients
@pytest.mark.parametrize("Tq,Tk,D,causal,rate", CASES)
def test_function_output_and_gradients_match_jax_vjp(Tq, Tk, D, causal, rate):
    arrays, lens, g = _inputs(Tq, Tk, D)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = port_flash.flash_attention(*ts, kv_lens=torch.from_numpy(lens), causal=causal,
                                     dropout_rate=rate, dropout_seed=SEED if rate else None)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    want_out, want_grads = _jax_vjp(Tq, Tk, D, causal, rate)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    for name, t, want in zip(("q", "k", "v"), ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), want, err_msg=name, **TOL)
    assert not ts[1].grad[2].any() and not ts[2].grad[2].any()  # no live key, no gradient


def test_backward_wrappers_compose_the_whole_backward():
    arrays, lens, g = _inputs(45, 130, 96, seed=3)
    a = [torch.from_numpy(x) for x in arrays]
    lens, g = torch.from_numpy(lens), torch.from_numpy(g)
    out, lse = port_flash.flash_attention_plain(*a, lens, True, 0.2, 9, return_lse=True)
    whole = port_flash.flash_attention_bwd_plain(*a, lens, out, lse, g, True, 0.2, 9)
    delta = port_flash._delta(out, g)
    parts = (port_flash.flash_bwd_dq(*a, lens, lse, delta, g, True, 0.2, 9),
             *port_flash.flash_bwd_dkv(*a, lens, lse, delta, g, True, 0.2, 9))
    for name, x, y in zip(("dq", "dk", "dv"), parts, whole):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6, msg=name)


def test_causal_rows_see_only_earlier_keys():
    # under the causal mask row i of the output depends on keys 0..i only
    (q, k, v), _, _ = _inputs(20, 20, 64, B=1)
    q, k, v = map(torch.from_numpy, (q, k, v))
    base = port_flash.flash_attention(q, k, v, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 12:] += 1.0
    v2[:, :, 12:] -= 1.0
    moved = port_flash.flash_attention(q, k2, v2, causal=True)
    torch.testing.assert_close(moved[:, :, :12], base[:, :, :12], rtol=0, atol=0)
    assert not torch.allclose(moved[:, :, 12:], base[:, :, 12:])


def test_flash_refuses_what_it_does_not_take():
    (q, k, v), _, _ = _inputs(8, 8, 64, B=1)
    q, k, v = map(torch.from_numpy, (q, k, v))
    with pytest.raises(ValueError, match="requires dropout_seed"):
        port_flash.flash_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError, match="expected shape"):
        port_flash.flash_attention(q, k[..., :32], v)
    with pytest.raises(TypeError):
        port_flash.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="unsupported device"):
        port_flash.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
