"""Port: legacy relative positions (``conformer_rel_pos_type: legacy``)
against the JAX package: ``LegacyRelPositionalEncoding``, the dense
``LegacyRelPositionMultiHeadedAttention``, ``rel_flash_attention(...,
legacy=True)`` (the plain versions of kernels 2 and 6-8 at twice the q_v /
table width), and a tiny legacy AAS-VC.

The JAX flash kernels run in interpret mode at block 32, as the JAX
package's own tests run them. Their dropout index runs over T padded to the
block, the port's over T padded to 128 (the JAX entry's default block), so
the dropout case takes T = 100, where both pads are 128 and the masks are
the same bits. Inputs come from a numpy seed, with key-length padding and a
fully masked batch row.

Tolerances (float32): the flash forward and the five input gradients atol
2e-5 and rtol 1e-5, as tests/test_torch_rel_flash_bwd.py holds the new
style (softmax-weighted sums of at most 100 products taken in another
order); the dense module atol 1e-5. The tiny AAS-VC as
tests/test_torch_aas_vc.py and tests/test_torch_train.py hold the new
style: durations exactly, features atol 1e-4 and rtol 1e-4, loss terms
rtol 1e-5, each gradient tensor within 1e-4 of its largest magnitude, the
``linear_k`` biases (true gradient 0) atol 1e-7. The JAX model's flash
route is reached by lowering its attention modules' gate to 0, as
tests/test_flash_attention.py::test_legacy_rel_flash_module_parity does.
Inference takes one jitted JAX run through its flash route, and the
training step's reference one jitted JAX step through its dense route (the
flash route's would cost 15 s more); each is held against the port's
flash and dense routes. The legacy flash VJP itself is held against the
JAX kernels' VJP above, and the JAX package's own test holds its flash
route to its dense one.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401 (release_jax_executables: autouse fixture)
    aasvc_pair,
    assert_state_dicts_equal,
    carried_back,
    release_jax_executables,
)
from seq2seq_vc_tpu.models import AASVC as JaxAASVC
from seq2seq_vc_tpu.nn.attention import (
    LegacyRelPositionMultiHeadedAttention as JaxLegacyMHA,
)
from seq2seq_vc_tpu.nn.positional_encoding import (
    LegacyRelPositionalEncoding as JaxLegacyPE,
)
from seq2seq_vc_tpu.ops import flash_attention as jax_flash
from seq2seq_vc_tpu.losses import get_criterion as jax_criterion
from seq2seq_vc_tpu.train.aas_vc import AASVCTrainer as JaxAASVCTrainer
from seq2seq_vc_tpu.train.optim import build_optimizer as jax_build_optimizer
from seq2seq_vc_tpu.train.state import TrainState as JaxTrainState
from seq2seq_vc_torch.convert import aasvc_state_dict
from seq2seq_vc_torch.nn.attention import LegacyRelPositionMultiHeadedAttention, rel_shift
from seq2seq_vc_torch.nn.positional_encoding import LegacyRelPositionalEncoding
from seq2seq_vc_torch.ops import flash_attention as port_flash
from test_torch_train import (
    CONFIG, NO_DROPOUT, OPT, TERMS, _batch, _inject_jax_noise, _inject_port_noise, _noise,
    _port_trainer,
)

TOL = dict(atol=2e-5, rtol=1e-5)
NAMES = ("q_u", "q_v", "k", "v", "pos")
SEED = 1234
LEGACY = dict(conformer_rel_pos_type="legacy")


def _inputs(T, D=16, B=3, H=2, seed=0):
    rng = np.random.default_rng(seed)
    qu, qv, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(4))
    pos = rng.standard_normal((H, T, D)).astype(np.float32)
    lens = np.array([T, T // 2 + 1, 0][:B], np.int32)  # full, padded, fully masked
    g = rng.standard_normal((B, H, T, D)).astype(np.float32)
    return (qu, qv, k, v, pos), lens, g


@functools.lru_cache(maxsize=None)
def _jax_vjp(T, rate):
    """(out, the five input cotangents) of the JAX legacy entry, block 32."""
    arrays, lens, g = _inputs(T)
    seed = jnp.asarray([SEED], jnp.int32) if rate > 0 else None
    out, vjp = jax.vjp(
        lambda *a: jax_flash.rel_flash_attention(
            *a, kv_lens=jnp.asarray(lens), block=32, legacy=True, dropout_rate=rate,
            dropout_seed=seed),
        *map(jnp.asarray, arrays))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


FLASH_CASES = [(37, 0.0), (100, 0.2)]  # T not a multiple of the block; see the docstring


# ------------------------------------------------ the encoding and rel_shift
def test_legacy_positional_encoding_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 23, 16)).astype(np.float32)
    want_x, want_pos = JaxLegacyPE(16).apply({}, jnp.asarray(x))
    got_x, got_pos = LegacyRelPositionalEncoding(16).eval()(torch.from_numpy(x))
    assert tuple(got_pos.shape) == (1, 23, 16)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_pos.numpy(), np.asarray(want_pos), rtol=0, atol=1e-6)


def test_legacy_rel_shift_folds_three_cases():
    """bd[i, j] = x[i, T-1-(i-j)] for j <= i, 0 for j = i+1, x[i+1, j-i-2]
    for j >= i+2: the three cases that ``legacy_rel_inputs`` folds into one
    band product."""
    T = 9
    x = torch.randn(1, 2, T, T)
    bd = rel_shift(x, legacy=True)
    for i in range(T):
        for j in range(T):
            if j <= i:
                want = x[..., i, T - 1 - (i - j)]
            elif j == i + 1:
                want = torch.zeros_like(x[..., 0, 0])
            else:
                want = x[..., i + 1, j - i - 2]
            torch.testing.assert_close(bd[..., i, j], want, rtol=0, atol=0)


# ------------------------------------------------ the dense attention module
def test_dense_legacy_attention_matches_jax():
    B, T, F, H = 2, 30, 32, 2
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    pos = rng.standard_normal((1, T, F)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.array([T, 19])[:, None])[:, None, :]
    jax_att = JaxLegacyMHA(H, F, backend="xla")
    params = jax_att.init(jax.random.PRNGKey(0), x, x, x, pos, mask)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    want = np.asarray(jax_att.apply(params, x, x, x, pos, mask))
    port = LegacyRelPositionMultiHeadedAttention(H, F)
    port.load_state_dict(aasvc_state_dict(params, port))
    assert port.route(T, T, T, torch.from_numpy(mask)) == "xla"
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = port.eval()(xt, xt, xt, torch.from_numpy(pos), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_legacy_module_routes():
    """Never the fused kernel; flash from the gate with a key-padding mask;
    zero_triu forces the dense ops."""
    mask = torch.ones(2, 1, 40, dtype=torch.bool)
    for backend in ("fused", "flash"):
        att = LegacyRelPositionMultiHeadedAttention(2, 16, backend=backend, flash_min_len=64)
        assert att.route(40, 40, 40, mask) == "xla"
    att = LegacyRelPositionMultiHeadedAttention(2, 16, backend="flash", flash_min_len=32)
    assert att.route(40, 40, 40, mask) == "flash"
    assert att.route(40, 40, 40, torch.ones(2, 40, 40, dtype=torch.bool)) == "xla"
    triu = LegacyRelPositionMultiHeadedAttention(2, 16, zero_triu=True, backend="flash",
                                                 flash_min_len=32)
    assert triu.route(40, 40, 40, mask) == "xla"


# ------------------------------------------- rel_flash_attention(legacy=True)
@pytest.mark.parametrize("T,rate", FLASH_CASES)
def test_legacy_flash_forward_matches_jax(T, rate):
    arrays, lens, _ = _inputs(T)
    out = port_flash.rel_flash_attention(*map(torch.from_numpy, arrays),
                                         kv_lens=torch.from_numpy(lens), dropout_rate=rate,
                                         dropout_seed=SEED if rate else None, legacy=True)
    np.testing.assert_allclose(out.numpy(), _jax_vjp(T, rate)[0], **TOL)
    assert not out[2].any()  # a row with no keys returns zeros


@pytest.mark.parametrize("T,rate", FLASH_CASES)
def test_legacy_flash_gradients_match_jax_vjp(T, rate):
    arrays, lens, g = _inputs(T)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = port_flash.rel_flash_attention(*ts, kv_lens=torch.from_numpy(lens), dropout_rate=rate,
                                         dropout_seed=SEED if rate else None, legacy=True)
    out.backward(torch.from_numpy(g))
    for name, t, want in zip(NAMES, ts, _jax_vjp(T, rate)[1]):
        assert t.grad.shape == t.shape, name
        np.testing.assert_allclose(t.grad.numpy(), want, err_msg=name, **TOL)


@pytest.mark.parametrize("T,rate", FLASH_CASES)
def test_legacy_plain_versions_alone_at_twice_the_width(T, rate):
    """The four plain versions called alone on the assembled (q_v2, table)
    at QW = 2D: the forward's output, and the backward pieces mapped back
    through the assembly, against the JAX entry and its VJP."""
    arrays, lens, g = _inputs(T)
    qu, qv, k, v, pos = (torch.from_numpy(a).requires_grad_() for a in arrays)
    qv2, table = port_flash.legacy_rel_inputs(qv, pos)
    D = qu.shape[-1]
    assert qv2.shape[-1] == table.shape[-1] == 2 * D and table.shape[1] == 2 * T - 1
    lens, g = torch.from_numpy(lens), torch.from_numpy(g)
    drop = (rate, SEED if rate else None)
    with torch.no_grad():
        out, lse = port_flash.rel_flash_attention_plain(qu, qv2, k, v, table, lens, *drop,
                                                        return_lse=True)
        args = (qu, qv2, k, v, table, lens, lse, port_flash._delta(out, g), g, *drop)
        dq_u, dq_v2 = port_flash.rel_flash_bwd_dq_plain(*args)
        dk, dv = port_flash.rel_flash_bwd_dkv_plain(*args)
        dtable = port_flash.rel_flash_bwd_dpos_plain(*args)
    assert dq_v2.shape == qv2.shape and dtable.shape == table.shape
    torch.autograd.backward([qv2, table], [dq_v2, dtable])
    want_out, want = _jax_vjp(T, rate)
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    for name, got, w in zip(NAMES, (dq_u, qv.grad, dk, dv, pos.grad), want):
        np.testing.assert_allclose(got.numpy(), w, err_msg=name, **TOL)


def test_legacy_table_layout():
    """Row p of the table <-> distance T-1-p: columns [0, D) hold pos[0 ..
    T-1] in rows 0 .. T-1, columns [D, 2D) pos[0 .. T-3] in rows T+1 ..
    2T-2, zeros elsewhere; q_v2 = [q_v[i], q_v[i+1]] with a zero last row."""
    T, D = 6, 3
    qv = torch.randn(1, 2, T, D)
    pos = torch.randn(2, T, D)
    qv2, table = port_flash.legacy_rel_inputs(qv, pos)
    torch.testing.assert_close(qv2[..., :D], qv, rtol=0, atol=0)
    torch.testing.assert_close(qv2[..., :-1, D:], qv[..., 1:, :], rtol=0, atol=0)
    assert not qv2[..., -1, D:].any()
    torch.testing.assert_close(table[:, :T, :D], pos, rtol=0, atol=0)
    assert not table[:, T:, :D].any() and not table[:, :T + 1, D:].any()
    torch.testing.assert_close(table[:, T + 1:, D:], pos[:, :T - 2], rtol=0, atol=0)
    for T in (1, 2):  # no second-half rows
        _, table = port_flash.legacy_rel_inputs(torch.randn(1, 1, T, D), torch.randn(1, T, D))
        assert table.shape == (1, 2 * T - 1, 2 * D) and not table[..., D:].any()


# ------------------------------------------------------ a tiny legacy AAS-VC
def _lower_jax_flash_gate():
    """Send every JAX legacy attention module at any key length down its
    flash route (the gate is a dataclass field the model does not expose)."""
    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, JaxLegacyMHA) and context.method_name == "__call__":
            object.__setattr__(context.module, "flash_train_min_len", 0)
        return next_fun(*args, **kwargs)

    return fnn.intercept_methods(interceptor)


def _legacy_pair(backend, seed=0, **over):
    """(port, JAX model, flax params) of the tiny legacy AAS-VC, the port's
    flash gate at 1 frame (every layer on the flash route) for "flash"."""
    return aasvc_pair(seed=seed, port_kw=dict(flash_min_len=1), attention_backend=backend,
                      **LEGACY, **over)


def test_legacy_weights_round_trip_exactly():
    port, _, flax = _legacy_pair("flash")
    assert all(isinstance(layer.self_attn, LegacyRelPositionMultiHeadedAttention)
               for stack in (port.encoder, port.decoder) for layer in stack.encoders)
    assert_state_dicts_equal(aasvc_state_dict(flax, port), port.state_dict())


B, T_SRC, MAX_OUT = 2, 48, 64
LENS = np.array([48, 36])


def _src():
    return np.random.default_rng(0).standard_normal((B, T_SRC, 80)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_legacy_inference():
    """The JAX model's inference through its flash route, jitted."""
    _, jax_model, flax = _legacy_pair("flash")

    def run(params, x):
        return jax_model.apply(params, x, LENS, x, max_output_frames=MAX_OUT,
                               method=JaxAASVC.inference, rngs={"noise": jax.random.PRNGKey(0)})

    with _lower_jax_flash_gate():
        return jax.tree_util.tree_map(np.asarray, jax.jit(run)(flax, _src()))


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_legacy_inference_matches_jax(backend):
    port, _, flax = _legacy_pair(backend)
    carried_back(flax, port)
    ref = _jax_legacy_inference()
    xt = torch.from_numpy(_src())
    calls = []
    wrapped = port_flash.rel_flash_attention
    with pytest.MonkeyPatch.context() as mp:
        from seq2seq_vc_torch.nn import attention
        mp.setattr(attention, "rel_flash_attention",
                   lambda *a, **kw: calls.append(kw["legacy"]) or wrapped(*a, **kw))
        got = port.inference(xt, torch.from_numpy(LENS), xt, max_output_frames=MAX_OUT)
    assert calls == ([True, True] if backend == "flash" else [])  # encoder and decoder layer
    np.testing.assert_array_equal(got["d_outs"].numpy(), ref["d_outs"])
    np.testing.assert_array_equal(got["out_lens"].numpy(), ref["out_lens"])
    for b, n in enumerate(ref["out_lens"]):
        np.testing.assert_allclose(got["outs"][b, :n].numpy(), ref["outs"][b, :n],
                                   atol=1e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax_legacy_grads():
    """The JAX trainer's loss terms and gradients for the tiny legacy
    AAS-VC through its dense route, the SDP's e_q given."""
    _, jax_model, flax = _legacy_pair("xla", **NO_DROPOUT)
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
    return {k: float(v) for k, v in metrics.items()}, grads


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_legacy_training_forward_matches_jax(backend):
    trainer = _port_trainer(backend, "auto", flash_min_len=1, **LEGACY)
    _inject_port_noise(trainer.model, _noise())
    trainer.model.train()
    loss, metrics = trainer.loss_fn(trainer._array_batch(_batch()), trainer._flags(),
                                    trainer.generator)
    loss.backward()
    want_metrics, want_grads = _jax_legacy_grads()
    for name in TERMS:
        np.testing.assert_allclose(metrics[name].item(), want_metrics[name], rtol=1e-5,
                                   err_msg=name)
    want_grads = aasvc_state_dict(want_grads, trainer.model)
    n_pos = 0
    for name, p in trainer.model.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        w = want_grads[name].numpy()
        if name.endswith("linear_k.bias"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-7, err_msg=name)
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=name)
        if name.endswith(("linear_pos.weight", "pos_bias_v")):
            assert np.abs(g).max() > 0, name
            n_pos += 1
    assert n_pos == 4  # the table path is live in the encoder's and the decoder's layer
