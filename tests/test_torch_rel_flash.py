"""Port: rel-pos flash attention, forward (seq2seq_vc_torch/ops/flash_attention.py).

The plain version (what a CPU tensor takes) against the JAX Pallas kernel
``rel_flash_attention`` run in interpret mode, with key-length padding and a
fully masked batch row, on ragged T. Inputs come from a numpy seed.
Tolerance: float32, atol 2e-5 and rtol 1e-5 (softmax-weighted sums of <= 130
values, taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import release_jax_executables  # noqa: F401 (autouse fixture)
from seq2seq_vc_tpu.ops.flash_attention import rel_flash_attention as jax_rel_flash
from seq2seq_vc_torch.ops.flash_attention import (
    rel_flash_attention,
    rel_flash_attention_plain,
)
from seq2seq_vc_torch.ops.rel_scores import fused_rel_scores_plain

TOL = dict(atol=2e-5, rtol=1e-5)


def _inputs(B, H, T, D, seed=0):
    rng = np.random.default_rng(seed)
    qu, qv, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(4))
    pos = rng.standard_normal((H, 2 * T - 1, D)).astype(np.float32)
    return qu, qv, k, v, pos


@pytest.mark.parametrize("T", [37, 130])
@pytest.mark.parametrize("D", [16, 48])
def test_plain_matches_jax_pallas_kernel(T, D):
    arrays = _inputs(3, 2, T, D)
    lens = np.array([T, T // 2 + 1, 0], np.int32)  # full, padded, fully masked
    ref = np.asarray(jax_rel_flash(*map(jnp.asarray, arrays), kv_lens=jnp.asarray(lens)))
    got = rel_flash_attention(*map(torch.from_numpy, arrays), kv_lens=torch.from_numpy(lens))
    assert got.shape == (3, 2, T, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert not got[2].any()  # a row with no keys returns zeros, as the kernel


def test_plain_matches_dense_softmax_attention():
    qu, qv, k, v, pos = map(torch.from_numpy, _inputs(2, 2, 50, 16, seed=1))
    lens = torch.tensor([50, 21])
    s = fused_rel_scores_plain(qu, qv, k, pos)
    valid = (torch.arange(50)[None, :] < lens[:, None])[:, None, None, :]
    w = torch.softmax(s.masked_fill(~valid, -1e9), dim=-1)
    want = torch.einsum("bhqk,bhkd->bhqd", w, v)
    got = rel_flash_attention_plain(qu, qv, k, v, pos, lens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_no_kv_lens_means_all_keys():
    qu, qv, k, v, pos = map(torch.from_numpy, _inputs(2, 2, 20, 8, seed=2))
    full = torch.tensor([20, 20])
    np.testing.assert_array_equal(
        rel_flash_attention(qu, qv, k, v, pos).numpy(),
        rel_flash_attention(qu, qv, k, v, pos, full).numpy(),
    )


def test_bf16_inputs_return_bf16():
    arrays = [torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(1, 2, 24, 8, seed=3)]
    got = rel_flash_attention(*arrays)
    want = rel_flash_attention_plain(*(t.float() for t in arrays))
    assert got.dtype == torch.bfloat16
    # the float32 result rounded once to bf16: within half a bf16 ulp
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=1e-2, rtol=4e-3)


def test_rejects_bad_shapes():
    qu, qv, k, v, pos = map(torch.from_numpy, _inputs(1, 2, 8, 4))
    with pytest.raises(ValueError):
        rel_flash_attention(qu, qv, k, v[:, :, :-1], pos)
    with pytest.raises(ValueError):
        rel_flash_attention(qu, qv, k, v, pos, kv_lens=torch.tensor([8, 8]))

