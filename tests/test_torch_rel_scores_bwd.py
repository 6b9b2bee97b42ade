"""Port: the fused rel-scores backward (seq2seq_vc_torch/ops/rel_scores.py).

The plain backward (what a CPU tensor takes for ``bwd="banded"``) and the
autograd Function's gradients, against ``jax.vjp`` of the JAX package's
``fused_rel_scores`` with ``bwd="banded"`` (its Pallas kernel in interpret
mode) and ``bwd="xla"``, on ragged T (37, 130; the plain backward also at
200, several 64-row tiles of the card's kernels with a partial last one)
and D 16 and 48, with the same numpy cotangent. Tolerance: float32, atol
2e-5 and rtol 1e-5 (sums of at most B*T = 400 products of unit-variance
numbers, taken in another order). bf16 inputs: the float32 result is rounded once to bf16, so rtol
2^-7 (one bf16 ulp) and atol 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import release_jax_executables  # noqa: F401 (autouse fixture)
from seq2seq_vc_tpu.ops.rel_scores import fused_rel_scores as jax_fused_rel_scores
from seq2seq_vc_torch.nn.attention import RelPositionMultiHeadedAttention
from seq2seq_vc_torch.ops import rel_scores
from seq2seq_vc_torch.ops.flash_attention import rel_flash_attention
from seq2seq_vc_torch.ops.rel_scores import (
    AUTO_BANDED_MIN_LEN,
    fused_rel_scores,
    fused_rel_scores_bwd_plain,
    rel_band_bwd,
    rel_band_bwd_plain,
    resolve_bwd,
)

TOL = dict(atol=2e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-5, rtol=2 ** -7)
B, H = 2, 2
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


def _inputs(T, D, seed=0):
    rng = np.random.default_rng(seed)
    qu, qv, k = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(3))
    pos = rng.standard_normal((H, 2 * T - 1, D)).astype(np.float32)
    g = rng.standard_normal((B, H, T, T)).astype(np.float32)
    return (qu, qv, k, pos), g


@functools.lru_cache(maxsize=None)
def _jax_grads(bwd, T, D):
    """(q_u, q_v, k, pos) cotangents of the JAX function for the seeded g."""
    arrays, g = _inputs(T, D)
    _, vjp = jax.vjp(
        lambda *a: jax_fused_rel_scores(*a, bwd=bwd), *map(jnp.asarray, arrays)
    )
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _assert_grads(got, want, tol=TOL):
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a.detach().float().numpy(), b, err_msg=name, **tol)


@pytest.mark.parametrize("jax_bwd", ["banded", "xla"])
@pytest.mark.parametrize("T", [37, 130, 200])
@pytest.mark.parametrize("D", [16, 48])
def test_plain_backward_matches_jax(jax_bwd, T, D):
    arrays, g = _inputs(T, D)
    got = fused_rel_scores_bwd_plain(torch.from_numpy(g), *map(torch.from_numpy, arrays))
    assert [tuple(x.shape) for x in got] == [a.shape for a in arrays]
    _assert_grads(got, _jax_grads(jax_bwd, T, D))


@pytest.mark.parametrize("bwd", ["banded", "xla"])
@pytest.mark.parametrize("T", [37, 130])
@pytest.mark.parametrize("D", [16, 48])
def test_function_gradients_match_jax(bwd, T, D):
    arrays, g = _inputs(T, D)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    scores = fused_rel_scores(*ts, bwd=bwd)
    assert scores.requires_grad and scores.grad_fn is not None
    scores.backward(torch.from_numpy(g))
    _assert_grads([t.grad for t in ts], _jax_grads(bwd, T, D))


def test_bf16_backward_rounds_the_float32_result_once():
    arrays, g = _inputs(37, 16, seed=3)
    ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in arrays]
    fused_rel_scores(*ts, bwd="banded").backward(torch.from_numpy(g))
    want = fused_rel_scores_bwd_plain(torch.from_numpy(g), *(t.detach().float() for t in ts))
    for name, t, w in zip(NAMES, ts, want):
        assert t.grad.dtype == torch.bfloat16, name
        np.testing.assert_allclose(t.grad.float().numpy(), w.numpy(), err_msg=name, **BF16_TOL)


@pytest.mark.parametrize("T", [37, 130])
def test_xla_and_banded_variants_agree(T):
    arrays, g = _inputs(T, 48, seed=4)
    grads = {}
    for bwd in ("xla", "banded"):
        ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
        fused_rel_scores(*ts, bwd=bwd).backward(torch.from_numpy(g))
        grads[bwd] = [t.grad.numpy() for t in ts]
    _assert_grads([torch.from_numpy(a) for a in grads["xla"]], grads["banded"])


def test_auto_gate_picks_the_variant(monkeypatch):
    assert resolve_bwd("auto", AUTO_BANDED_MIN_LEN - 1) == "xla"
    assert resolve_bwd("auto", AUTO_BANDED_MIN_LEN) == "banded"
    assert resolve_bwd("xla", 10 * AUTO_BANDED_MIN_LEN) == "xla"
    assert resolve_bwd("banded", 1) == "banded"
    assert resolve_bwd("pallas", 10 * AUTO_BANDED_MIN_LEN) == "pallas"  # named, never picked
    with pytest.raises(ValueError, match="unknown bwd"):
        resolve_bwd("bogus", 8)

    taken = []
    monkeypatch.setattr(rel_scores, "rel_band_bwd",
                        lambda *a: taken.append("banded") or rel_band_bwd_plain(*a))
    monkeypatch.setattr(rel_scores, "rel_band_bwd_xla",
                        lambda *a: taken.append("xla") or rel_band_bwd_plain(*a))
    monkeypatch.setattr(rel_scores, "AUTO_BANDED_MIN_LEN", 20)
    for T in (19, 20):
        arrays, g = _inputs(T, 8)
        ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
        fused_rel_scores(*ts).backward(torch.from_numpy(g))
    assert taken == ["xla", "banded"]


def test_cpu_backward_launches_no_kernel():
    fused_rel_scores.launches = rel_band_bwd.launches = 0
    arrays, g = _inputs(37, 16)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    fused_rel_scores(*ts, bwd="banded").backward(torch.from_numpy(g))
    assert (fused_rel_scores.launches, rel_band_bwd.launches) == (0, 0)


def test_backward_wrapper_rejects_bad_inputs():
    (_, qv, _, pos), g = _inputs(8, 4)
    qv, pos, g = map(torch.from_numpy, (qv, pos, g))
    with pytest.raises(ValueError, match="g must be"):
        rel_band_bwd(g[:, :, :-1], qv, pos)
    with pytest.raises(ValueError):
        rel_band_bwd(g, qv, pos[:, :-1])
    with pytest.raises(TypeError):
        rel_band_bwd(g, qv.double(), pos)
    with pytest.raises(ValueError, match="unsupported device"):
        rel_band_bwd(g.to("meta"), qv.to("meta"), pos.to("meta"))


def _flash_inputs(T=20, D=8):
    (qu, qv, k, pos), _ = _inputs(T, D, seed=5)
    v = np.random.default_rng(6).standard_normal(qu.shape).astype(np.float32)
    return [torch.from_numpy(a) for a in (qu, qv, k, v, pos)]


def test_flash_training_step_gives_gradients_on_the_cpu():
    att = RelPositionMultiHeadedAttention(2, 16, backend="flash", flash_min_len=8).train()
    x = torch.randn(1, 12, 16)
    pos = torch.randn(1, 23, 16)
    assert att.route(12, 12, 23, None) == "flash"
    att(x, x, x, pos).sum().backward()
    for name, p in att.named_parameters():
        if name != "linear_k.bias":  # true gradient 0: a softmax ignores a shift of every key
            assert p.grad is not None and p.grad.abs().sum() > 0, name
    # under no_grad the forward runs alone, with no graph
    with torch.no_grad():
        out = rel_flash_attention(*_flash_inputs())
    assert out.shape == (B, H, 20, 8) and not out.requires_grad


def test_flash_dropout_without_a_seed_raises():
    ts = _flash_inputs()
    with pytest.raises(ValueError, match="requires dropout_seed"):
        rel_flash_attention(*ts, dropout_rate=0.1)
    with pytest.raises(ValueError, match="dropout_rate"):
        rel_flash_attention(*ts, dropout_rate=1.0, dropout_seed=3)
    assert rel_flash_attention(*ts, dropout_rate=0.1, dropout_seed=3).shape == ts[0].shape


def test_flash_module_with_the_same_seed_repeats_itself():
    att = RelPositionMultiHeadedAttention(2, 16, dropout_rate=0.2, backend="flash",
                                          flash_min_len=8).train()
    x = torch.randn(1, 12, 16)
    pos = torch.randn(1, 23, 16)

    def run(seed):  # the dropout seed comes from torch's seeded generator
        torch.manual_seed(seed)
        return att(x, x, x, pos)

    with torch.no_grad():
        a, b, c = run(11), run(11), run(12)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not torch.equal(a, c)
        # eval() drops nothing: the seed does not matter
        att.eval()
        torch.testing.assert_close(run(1), run(2), rtol=0, atol=0)
