"""Port: the options of ROADMAP.md queue 1 item 8 against the JAX package:
the conformer's standard self-attention (``selfattn``) with the absolute
encodings (``abs_pos``, ``scaled_abs_pos``) and its ``embed`` input layer,
the VTN's ``encoder_input_layer`` (``linear``, ``conv2d``, ``embed``,
``None``), and the transformer encoder layer's relative self-attention
(``rel_selfattn``, ``legacy_rel_selfattn``); for AAS-VC with a ``selfattn``
conformer, one training step's loss terms and gradients.

The JAX package's converters read the reference's rel-pos conformer
layout only, so here the weights go the other way: each JAX module is
initialised from a seed and carried into the port by the port's own
converter (``seq2seq_vc_torch/convert.py``), which must consume every
leaf. Dropout is off on both sides. The JAX MHA runs dense under every
backend but ``flash``; the port's ``selfattn`` conformer takes the backend
as that rule maps it (``fused`` runs dense) and, under ``flash`` with its
gate lowered below the test's lengths, the flash kernels' plain versions.

Tolerances (float32): module outputs atol 2e-5 (sums of up to 64 products
in another order through two layers, as tests/test_torch_options.py);
the AAS-VC step as tests/test_torch_train.py: loss terms rtol 1e-5, each
gradient within 1e-4 of its largest magnitude, the ``linear_k`` biases
(whose true gradient is 0) atol 1e-7.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from _torch_port import NO_DROPOUT, TINY_AASVC, TINY_VTN, release_jax_executables  # noqa: F401
from seq2seq_vc_tpu.losses import get_criterion as jax_criterion
from seq2seq_vc_tpu.models import AASVC as JaxAASVC
from seq2seq_vc_tpu.models import VTN as JaxVTN
from seq2seq_vc_tpu.nn.conformer import ConformerEncoder as JaxConformerEncoder
from seq2seq_vc_tpu.nn.transformer import Encoder as JaxEncoder
from seq2seq_vc_tpu.train.aas_vc import AASVCTrainer as JaxAASVCTrainer
from seq2seq_vc_tpu.train.optim import build_optimizer as jax_build_optimizer
from seq2seq_vc_tpu.train.state import TrainState as JaxTrainState
from seq2seq_vc_torch.convert import aasvc_state_dict, vtn_state_dict
from seq2seq_vc_torch.losses import get_criterion
from seq2seq_vc_torch.models.aas_vc import AASVC
from seq2seq_vc_torch.models.vtn import VTN
from seq2seq_vc_torch.nn.conformer import ConformerEncoder
from seq2seq_vc_torch.nn.transformer import Encoder
from seq2seq_vc_torch.train.aas_vc import AASVCTrainer
from seq2seq_vc_torch.train.optim import build_optimizer
from seq2seq_vc_torch.train.state import TrainState
from test_torch_train import (
    CONFIG,
    OPT,
    TERMS,
    _batch,
    _inject_jax_noise,
    _inject_port_noise,
    _noise,
)

TOL = dict(atol=2e-5, rtol=0)
KEYS = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
        "noise": jax.random.PRNGKey(2)}
ENC = dict(attention_dim=32, attention_heads=2, linear_units=64, num_blocks=2, dropout_rate=0.0,
           positional_dropout_rate=0.0, attention_dropout_rate=0.0)
VOCAB = 19


def _inputs(kind, seed=0, B=2, T=40, idim=24):
    """(xs, masks) numpy: features, or token ids for an ``embed`` layer."""
    rng = np.random.default_rng(seed)
    xs = (rng.integers(1, VOCAB, (B, T)) if kind == "embed"
          else rng.standard_normal((B, T, idim)).astype(np.float32))
    return xs, np.arange(T)[None, :] < np.array([T, T - 9])[:, None]


def _carried(jax_module, port, convert, *args):
    """``port`` (eval) with the JAX module's seeded weights, and those
    weights (a jitted init: eager takes several times as long)."""
    params = jax.jit(jax_module.init)(KEYS, *args)["params"]
    port.load_state_dict(convert(params, port))
    return port.eval(), params


# (self-attention, encoding, input layer, the port's backend)
CONFORMER_CASES = [
    ("selfattn", "abs_pos", "linear", "xla"),
    ("selfattn", "scaled_abs_pos", "linear", "flash"),
    ("selfattn", "abs_pos", "conv2d", "fused"),
    ("selfattn", "scaled_abs_pos", "embed", "xla"),
    ("rel_selfattn", "rel_pos", "embed", "xla"),
]


@pytest.mark.parametrize("attn,pos,layer,backend", CONFORMER_CASES)
def test_conformer_options_match_jax(attn, pos, layer, backend):
    idim = VOCAB if layer == "embed" else 24
    cfg = dict(ENC, input_layer=layer, pos_enc_layer_type=pos, selfattention_layer_type=attn,
               cnn_module_kernel=7)
    xs, masks = _inputs(layer, idim=idim)
    jax_enc = JaxConformerEncoder(idim, **cfg)
    port, params = _carried(jax_enc, ConformerEncoder(idim, **cfg, attention_backend=backend,
                                                      flash_min_len=8),
                            aasvc_state_dict, xs, masks)
    want, want_mask = jax_enc.apply({"params": params}, xs, masks)
    with torch.no_grad():
        got, mask = port(torch.from_numpy(xs), torch.from_numpy(masks))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if backend == "flash":  # the standard module's flash route, not the dense one
        key_padding = torch.from_numpy(masks)[:, None]
        assert port.encoders[0].self_attn.route(xs.shape[1], key_padding) == "flash"
    if pos == "scaled_abs_pos":
        assert port.pos_enc.alpha.item() == float(params["pos_enc"]["alpha"])


@pytest.mark.parametrize("layer", ["linear", "conv2d", "embed", None])
def test_vtn_encoder_input_layers_match_jax(layer):
    idim = {"embed": VOCAB, None: TINY_VTN["adim"]}.get(layer, 80)
    cfg = dict(TINY_VTN, **NO_DROPOUT, idim=idim, encoder_input_layer=layer)
    rng = np.random.default_rng(3)
    B, Tin, L = 2, 48, 40
    xs = (rng.integers(1, VOCAB, (B, Tin)) if layer == "embed"
          else rng.standard_normal((B, Tin, idim)).astype(np.float32))
    ys = rng.standard_normal((B, L, 80)).astype(np.float32)
    ilens, olens = np.array([Tin, Tin - 11], np.int32), np.array([L, L - 11], np.int32)
    labels = (np.arange(L)[None, :] >= olens[:, None] - 1).astype(np.float32)
    batch = (xs, ilens, ys, labels, olens)
    jax_model = JaxVTN(**cfg)
    port, params = _carried(jax_model, VTN(**cfg), vtn_state_dict, *batch)
    want = jax.jit(functools.partial(jax_model.apply, deterministic=True))(
        {"params": params}, *batch, rngs={"dropout": KEYS["dropout"]})
    port.postnet.dropout_rate = 0.0  # the JAX model's deterministic postnet
    with torch.no_grad():
        got = port(*(torch.from_numpy(np.asarray(a)) for a in batch))
    np.testing.assert_array_equal(got["ilens_ds_st"].numpy(), np.asarray(want["ilens_ds_st"]))
    for k in ("after_outs", "logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    assert port.encoder.conv_subsampling_factor == (4 if layer == "conv2d" else 1)


@pytest.mark.parametrize("attn,pos", [("rel_selfattn", "rel_pos"),
                                      ("legacy_rel_selfattn", "legacy_rel_pos")])
def test_transformer_encoder_layer_relative_attention_matches_jax(attn, pos):
    cfg = dict(ENC, input_layer="linear", selfattention_layer_type=attn)
    xs, masks = _inputs("linear")
    jax_enc = JaxEncoder(24, pos_enc_type=pos, **cfg)
    port, params = _carried(jax_enc, Encoder(24, pos_enc_type=pos, **cfg), vtn_state_dict,
                            xs, masks)
    want, _ = jax_enc.apply({"params": params}, xs, masks)
    with torch.no_grad():
        got, _ = port(torch.from_numpy(xs), torch.from_numpy(masks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert port.encoders[0].self_attn.legacy == attn.startswith("legacy")


# the tiny AAS-VC with a standard-attention, absolute-encoding conformer
SELFATTN_AASVC = dict(TINY_AASVC, **NO_DROPOUT, postnet_dropout_rate=0.0,
                      stochastic_duration_predictor_dropout_rate=0.0,
                      conformer_self_attn_layer_type="selfattn",
                      conformer_pos_enc_layer_type="abs_pos")


def _aasvc_steps():
    """(port, JAX) loss terms and gradients of one AASVCTrainer step of the
    selfattn AAS-VC, from the JAX model's seeded weights."""
    b = _batch()
    jax_model = JaxAASVC(**SELFATTN_AASVC, alignment_dist_form="direct")
    flax = jax.jit(functools.partial(jax_model.init, deterministic=True))(
        KEYS, b["xs"], b["ilens"], b["ys"], b["olens"], b["dp_inputs"], b["dplens"])
    tx, _ = jax_build_optimizer(**OPT)
    trainer = JaxAASVCTrainer(jax_model, JaxTrainState.create(flax, tx),
                              {"L1Loss": jax_criterion("L1Loss")}, dict(CONFIG), [],
                              mesh=None, writer=False)
    arrays = trainer._array_batch(b)
    rngs = {"dropout": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    with _inject_jax_noise(_noise()):
        (_, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: trainer.loss_fn(p, arrays, rngs, trainer._flags()), has_aux=True
        ))(flax)
    want = {k: float(v) for k, v in metrics.items()}

    torch.manual_seed(0)
    port = AASVC(**SELFATTN_AASVC)
    port.load_state_dict(aasvc_state_dict(flax, port))
    state = TrainState(port, build_optimizer(port.parameters(), **OPT))
    ptrainer = AASVCTrainer(state, {"L1Loss": get_criterion("L1Loss")}, dict(CONFIG), (),
                            device="cpu")
    _inject_port_noise(ptrainer.model, _noise())
    ptrainer.model.train()
    loss, got = ptrainer.loss_fn(ptrainer._array_batch(b), ptrainer._flags(), ptrainer.generator)
    loss.backward()
    got_grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
                 for k, p in port.named_parameters()}
    return ({k: v.item() for k, v in got.items()}, want, got_grads,
            aasvc_state_dict(grads, port))


def test_selfattn_aasvc_step_matches_jax():
    # one test for both, so that the JAX step compiles once
    got, want, grads, want_grads = _aasvc_steps()
    for name in TERMS:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, err_msg=name)
    assert set(grads) == set(want_grads)
    n_attention = 0
    for name, w in want_grads.items():
        g, w = grads[name].numpy(), w.numpy()
        if name.endswith("linear_k.bias"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-7, err_msg=name)
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=name)
        if ".self_attn.linear_" in name and name.endswith("weight"):
            assert np.abs(g).max() > 0, name
            n_attention += 1
    assert n_attention == 2 * 4  # q, k, v, out in the encoder and the decoder: no linear_pos
