"""Port: fused rel-pos scores (seq2seq_vc_torch/ops/rel_scores.py).

The plain version (what a CPU tensor takes) against the JAX Pallas kernel
run in interpret mode, and against the port's own dense ``rel_shift`` path,
on ragged T. Inputs come from a numpy seed. Tolerance: float32, atol 2e-5
and rtol 1e-5 (sums of <= 48 products, taken in another order).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import release_jax_executables  # noqa: F401 (autouse fixture)
from seq2seq_vc_tpu.ops.rel_scores import fused_rel_scores as jax_fused_rel_scores
from seq2seq_vc_torch.nn.attention import rel_shift
from seq2seq_vc_torch.ops.rel_scores import fused_rel_scores, fused_rel_scores_plain

TOL = dict(atol=2e-5, rtol=1e-5)


def _inputs(B, H, T, D, seed=0):
    rng = np.random.default_rng(seed)
    qu, qv, k = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(3))
    pos = rng.standard_normal((H, 2 * T - 1, D)).astype(np.float32)
    return qu, qv, k, pos


@pytest.mark.parametrize("T", [37, 130, 200])  # 200: several 64 x 64 tiles of the card's kernel
@pytest.mark.parametrize("D", [16, 48])
def test_plain_matches_jax_pallas_kernel(T, D):
    qu, qv, k, pos = _inputs(2, 2, T, D)
    ref = np.asarray(jax_fused_rel_scores(*map(jnp.asarray, (qu, qv, k, pos))))
    got = fused_rel_scores(*map(torch.from_numpy, (qu, qv, k, pos)))
    assert got.shape == (2, 2, T, T) and got.dtype == torch.float32
    # the JAX kernel returns the valid (T, T) region only
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("T", [37, 130])
def test_plain_matches_dense_rel_shift(T):
    qu, qv, k, pos = map(torch.from_numpy, _inputs(1, 2, T, 16, seed=1))
    dense = (
        torch.einsum("bhqd,bhkd->bhqk", qu, k)
        + rel_shift(torch.einsum("bhqd,hpd->bhqp", qv, pos))
    ) / math.sqrt(16)
    np.testing.assert_allclose(fused_rel_scores_plain(qu, qv, k, pos).numpy(), dense.numpy(), **TOL)


def test_bf16_inputs_compute_in_float32():
    qu, qv, k, pos = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(1, 2, 37, 16, seed=2))
    got = fused_rel_scores(qu, qv, k, pos)
    ref = fused_rel_scores_plain(*(t.float() for t in (qu, qv, k, pos)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_rejects_bad_shapes_and_dtypes():
    qu, qv, k, pos = map(torch.from_numpy, _inputs(1, 2, 8, 4))
    with pytest.raises(ValueError):
        fused_rel_scores(qu, qv, k, pos[:, :-1])
    with pytest.raises(TypeError):
        fused_rel_scores(qu.double(), qv, k, pos)

