"""Port: the ``bwd="pallas"`` backward of the fused rel-scores kernel, the
diagonal-reduction pair (kernels 4 and 5: ``rel_band_bwd_dqv``,
``rel_band_bwd_dpos`` in seq2seq_vc_torch/ops/rel_scores.py).

Their plain versions (what a CPU tensor takes) and the autograd Function's
gradients with ``bwd="pallas"``, against ``jax.vjp`` of the JAX package's
``fused_rel_scores`` with ``bwd="pallas"`` (its ``_dqv_kernel`` and
``_dtab_kernel`` in interpret mode, block 128) with the same numpy
cotangent, at two shapes: a ragged T of 130 (two blocks there) and T 37 at
D 20 (one padded block; a width whose bf16 rows are not 16-byte aligned on
the card). Tolerance: float32, atol 2e-5 and rtol 1e-5, as
tests/test_torch_rel_scores_bwd.py holds kernel 3 (sums of at most B*T =
260 products of unit-variance numbers, taken in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import release_jax_executables  # noqa: F401 (autouse fixture)
from seq2seq_vc_tpu.ops.rel_scores import fused_rel_scores as jax_fused_rel_scores
from seq2seq_vc_torch.ops.rel_scores import (
    AUTO_BANDED_MIN_LEN,
    BWD_VARIANTS,
    fused_rel_scores,
    rel_band_bwd_dpos,
    rel_band_bwd_dpos_plain,
    rel_band_bwd_dqv,
    rel_band_bwd_dqv_plain,
    rel_band_bwd_plain,
    resolve_bwd,
)

TOL = dict(atol=2e-5, rtol=1e-5)
SHAPE = (2, 2, 130, 48)  # (B, H, T, D)
SHAPES = [SHAPE, (1, 2, 37, 20)]
NAMES = ("q_u", "q_v", "k", "pos")


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_compilation_cache():
    """Keep JAX's persistent compilation cache off for this file's JAX
    calls: a test in the same worker that ran one of the JAX package's CLIs
    turned it on (``seq2seq_vc_tpu/core/cache.py``), and writes to the cache
    that all workers share have crashed an eager ``jax.vjp`` here. The
    setting and the cache's state are restored afterwards."""
    from jax._src import compilation_cache

    old = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_compilation_cache_dir", old)
    compilation_cache.reset_cache()


def _inputs(seed=0, shape=SHAPE):
    B, H, T, D = shape
    rng = np.random.default_rng(seed)
    qu, qv, k = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(3))
    pos = rng.standard_normal((H, 2 * T - 1, D)).astype(np.float32)
    g = rng.standard_normal((B, H, T, T)).astype(np.float32)
    return (qu, qv, k, pos), g


@functools.lru_cache(maxsize=None)
def _jax_grads(shape=SHAPE):
    """(q_u, q_v, k, pos) cotangents of the JAX function, bwd="pallas"."""
    arrays, g = _inputs(shape=shape)
    _, vjp = jax.vjp(lambda *a: jax_fused_rel_scores(*a, bwd="pallas"), *map(jnp.asarray, arrays))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}_H{}_T{}_D{}".format(*s))
@pytest.mark.parametrize("which", ["dq_v", "dpos"])
def test_pair_plain_versions_match_jax_pallas(which, shape):
    (_, qv, _, pos), g = _inputs(shape=shape)
    args = (torch.from_numpy(g), torch.from_numpy(qv), torch.from_numpy(pos))
    if which == "dq_v":
        got, want = rel_band_bwd_dqv_plain(*args), _jax_grads(shape)[1]
    else:
        got, want = rel_band_bwd_dpos_plain(*args), _jax_grads(shape)[3]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}_H{}_T{}_D{}".format(*s))
def test_pallas_function_gradients_match_jax_vjp(shape):
    arrays, g = _inputs(shape=shape)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    scores = fused_rel_scores(*ts, bwd="pallas")
    assert scores.grad_fn is not None
    scores.backward(torch.from_numpy(g))
    for name, t, want in zip(NAMES, ts, _jax_grads(shape)):
        np.testing.assert_allclose(t.grad.numpy(), want, err_msg=name, **TOL)


def test_pair_is_the_banded_backward_split_in_two():
    (_, qv, _, pos), g = _inputs(seed=1)
    args = (torch.from_numpy(g), torch.from_numpy(qv), torch.from_numpy(pos))
    whole = rel_band_bwd_plain(*args)
    pair = (rel_band_bwd_dqv(*args), rel_band_bwd_dpos(*args))  # the CPU takes the plain versions
    for name, a, b in zip(("dq_v", "dpos"), pair, whole):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_auto_never_picks_pallas():
    assert "pallas" in BWD_VARIANTS
    assert resolve_bwd("pallas", 8) == "pallas"
    for t in (1, AUTO_BANDED_MIN_LEN - 1, AUTO_BANDED_MIN_LEN, 4096, 10 ** 6):
        assert resolve_bwd("auto", t) in ("xla", "banded")


def test_pair_wrappers_reject_bad_inputs():
    (_, qv, _, pos), g = _inputs()
    qv, pos, g = map(torch.from_numpy, (qv, pos, g))
    for wrapper in (rel_band_bwd_dqv, rel_band_bwd_dpos):
        with pytest.raises(ValueError, match="g must be"):
            wrapper(g[:, :, :-1], qv, pos)
        with pytest.raises(ValueError):
            wrapper(g, qv, pos[:, :-1])
        with pytest.raises(TypeError):
            wrapper(g, qv.double(), pos)
        with pytest.raises(ValueError, match="unsupported device"):
            wrapper(g.to("meta"), qv.to("meta"), pos.to("meta"))
