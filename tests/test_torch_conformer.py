"""Port: rel-pos attention and the conformer stack (seq2seq_vc_torch/nn/).

JAX modules are initialised from a seed, their parameters perturbed with
seeded numpy noise and carried into the port by seq2seq_vc_torch/convert.py;
the same numpy inputs then go through both. Each port backend (``xla``,
``fused``, ``flash``) is held against the JAX backend of the same name, run on
the CPU as the JAX package's own tests run it (the Pallas kernels in
interpret mode). Tolerance: float32, atol 2e-5 and rtol 1e-5 for one
attention layer; atol 1e-4 and rtol 1e-4 for the two-layer stack, whose
LayerNorms and softmaxes compound the reordering of float32 sums. The
forward passes run under ``torch.no_grad()`` (the flash route's backward is
tested in tests/test_torch_rel_flash_bwd.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import release_jax_executables  # noqa: F401 (autouse fixture)
from seq2seq_vc_tpu.nn.attention import (
    RelPositionMultiHeadedAttention as JaxRelMHA,
)
from seq2seq_vc_tpu.nn.conformer import ConformerEncoder as JaxConformerEncoder
from seq2seq_vc_torch.convert import aasvc_state_dict
from seq2seq_vc_torch.nn.attention import RelPositionMultiHeadedAttention
from seq2seq_vc_torch.nn.conformer import ConformerEncoder
from seq2seq_vc_torch.nn.positional_encoding import relative_pe
from seq2seq_vc_torch.ops.masks import make_non_pad_mask

BACKENDS = ["xla", "fused", "flash"]


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        params,
    )


def _load(port, flax):
    port.load_state_dict(aasvc_state_dict(flax, port))
    return port.eval()


@pytest.mark.parametrize("backend", BACKENDS)
def test_rel_attention_matches_jax(backend):
    B, T, F, H = 2, 40, 32, 2
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    pos = relative_pe(T, F).numpy()[None]
    lens = np.array([T, 23])
    mask = np.asarray(make_non_pad_mask(torch.from_numpy(lens), T))[:, None, :]
    # gate 16: the flash backends take the flash kernels at this T
    jax_att = JaxRelMHA(H, F, backend=backend, flash_train_min_len=16)
    params = _perturbed(jax_att.init(jax.random.PRNGKey(0), x, x, x, pos, mask), 1)
    ref = np.asarray(jax_att.apply(params, x, x, x, pos, mask))

    port = _load(RelPositionMultiHeadedAttention(H, F, backend=backend, flash_min_len=16), params)
    assert port.route(T, T, 2 * T - 1, torch.from_numpy(mask)) == (
        "fused" if backend == "fused" else backend
    )
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = port(xt, xt, xt, torch.from_numpy(pos), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-5)


def test_flash_backend_below_gate_takes_fused_path():
    att = RelPositionMultiHeadedAttention(2, 32, backend="flash", flash_min_len=64)
    mask = torch.ones(1, 1, 40, dtype=torch.bool)
    assert att.route(40, 40, 79, mask) == "fused"
    assert att.route(64, 64, 127, mask) == "flash"
    # a full (B, Tq, Tk) mask is not a key-padding mask: dense path
    assert att.route(64, 64, 127, torch.ones(1, 64, 64, dtype=torch.bool)) == "fused"
    assert RelPositionMultiHeadedAttention(2, 32, backend="xla").route(64, 64, 127, mask) == "xla"


@pytest.mark.parametrize("input_layer", ["linear", None])
@pytest.mark.parametrize("backend", BACKENDS)
def test_conformer_encoder_matches_jax(backend, input_layer):
    B, T, A = 2, 36, 32
    idim = 24 if input_layer == "linear" else A
    cfg = dict(attention_dim=A, attention_heads=2, linear_units=64, num_blocks=2,
               input_layer=input_layer, normalize_before=True,
               positionwise_layer_type="linear", cnn_module_kernel=7)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T, idim)).astype(np.float32)
    lens = np.array([T, 29])
    masks = np.arange(T)[None, :] < lens[:, None]
    # the JAX stack keeps its own (TPU) flash gate, so its flash backend
    # runs dense here; the port's gate 16 sends it through the flash path
    jax_enc = JaxConformerEncoder(idim, dropout_rate=0.0, positional_dropout_rate=0.0,
                                  attention_backend=backend, **cfg)
    params = _perturbed(jax_enc.init(jax.random.PRNGKey(3), x, masks), 4)
    ref, _ = jax_enc.apply(params, x, masks)

    port = _load(ConformerEncoder(idim, attention_backend=backend, flash_min_len=16, **cfg), params)
    with torch.no_grad():
        got, _ = port(torch.from_numpy(x), torch.from_numpy(masks))
    assert got.dtype == torch.float32
    for b, n in enumerate(lens):
        np.testing.assert_allclose(
            got[b, :n].numpy(), np.asarray(ref)[b, :n], atol=1e-4, rtol=1e-4
        )
