"""Port: the CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one. The file imports neither JAX nor the JAX package, so it runs where the
port runs:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -m cuda -q

(``--noconftest``: tests/conftest.py sets JAX up for the other tests.)

Tolerances. Scores: float32 arithmetic on both sides (bf16 inputs are
widened), sums of D products taken in another order: atol 1e-4, rtol 1e-5.
Flash in float32: the same, plus the online softmax's rescaling: atol 1e-5,
rtol 1e-5 on outputs of size ~1. Flash in bf16: the float32 result is rounded
once to bf16 on both sides, so a value next to a rounding edge may differ by
one bf16 ulp: atol 1e-2, rtol 1e-2. Backward (dq_v, dpos): float32 sums of
up to B*T products in another order: atol 1e-4, rtol 1e-5 in float32; in
bf16 the float32 result is rounded once to bf16 on both sides, so one bf16
ulp may separate them: atol 1e-2, rtol 2^-7. The flash backward kernels
(dq_u, dq_v, dk, dv, dpos) and the logsumexp: float32 sums of up to B*T
products in another order: atol 1e-4, rtol 1e-4 in float32; in bf16 one
rounding of the float32 result on both sides: atol 1e-2, rtol 2^-7. The
dropout masks are the same bits on both sides, so the rate does not change
a tolerance. The standard flash kernels (forward, lse, dq, dk/dv) as the
rel-pos ones. The legacy form and kernels 4 and 5 (the ``bwd="pallas"`` pair)
as the kernels they share their arithmetic with: the rel-pos flash kernels
and kernel 3. Kernels 2 and 6-8 in bf16 feed the weights P, Pd and dS to
the tensor cores rounded to bf16 (2^-9 relative each, in sums of many terms
of either sign), well inside the bf16 tolerances above. Kernels 10 and 11
in bf16 feed Pd and dS as a hi and a lo bf16 part (~2^-16 relative): one
rounding can, under the causal mask, where rows near the diagonal weigh
few keys heavily and the sum cancels, exceed the bf16 tolerance. Kernels
3-5 feed the float32 cotangent g the same way: one rounding of g puts the
table gradient's sums of B*T products, and some dq_v outputs, past the bf16
tolerance.
"""

import numpy as np
import pytest
import torch

from seq2seq_vc_torch.ops import flash_attention as fa
from seq2seq_vc_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_bwd_dkv,
    flash_bwd_dq,
    rel_flash_attention,
    rel_flash_attention_bwd_plain,
    rel_flash_attention_plain,
    rel_flash_bwd_dkv,
    rel_flash_bwd_dpos,
    rel_flash_bwd_dq,
)
from seq2seq_vc_torch.ops.rel_scores import (
    fused_rel_scores,
    fused_rel_scores_bwd_plain,
    fused_rel_scores_plain,
    rel_band_bwd,
    rel_band_bwd_dpos,
    rel_band_bwd_dpos_plain,
    rel_band_bwd_dqv,
    rel_band_bwd_dqv_plain,
    rel_band_bwd_plain,
)

pytestmark = pytest.mark.cuda

# (T, D): ragged T, the encoder's head dim 192 and the decoder's 768
SHAPES = [(37, 48), (130, 192), (70, 768)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU to run the CUDA kernels")
    return torch.device("cuda")


COUNTED = (fused_rel_scores, rel_band_bwd, rel_flash_attention, rel_flash_bwd_dq,
           rel_flash_bwd_dkv, rel_flash_bwd_dpos)
STD_COUNTED = (flash_attention, flash_bwd_dq, flash_bwd_dkv)
PAIR_COUNTED = (rel_band_bwd_dqv, rel_band_bwd_dpos)
LEGACY_COUNTED = COUNTED[2:]  # the rel-pos flash kernels, whose legacy launches count apart
BWD_TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=1e-2, rtol=2 ** -7)}


def _zero():
    for fn in COUNTED + STD_COUNTED + PAIR_COUNTED:
        fn.launches = 0
    for fn in LEGACY_COUNTED:
        fn.legacy_launches = 0


@pytest.fixture
def zero_counts():
    _zero()
    yield
    _zero()


def _inputs(device, dtype, B, H, T, D, seed):
    rng = np.random.default_rng(seed)
    qu, qv, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(4))
    pos = rng.standard_normal((H, 2 * T - 1, D)).astype(np.float32)
    return [torch.from_numpy(a).to(device, dtype) for a in (qu, qv, k, v, pos)]


# (T, D) for kernel 1's 64 x 64 tiles besides SHAPES: one row (the table
# window wholly past its edges but one row), one whole tile, several tiles
# with a partial last one at the encoder's D 192 and the decoder's D 768,
# and D 20, whose bf16 rows are not 16-byte aligned (staged by element loads)
REL_SCORES_SHAPES = [(1, 16), (64, 64), (200, 192), (333, 768), (130, 20)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D", SHAPES + REL_SCORES_SHAPES)
def test_rel_scores_kernel_matches_plain(cuda_device, dtype, T, D):
    qu, qv, k, _, pos = _inputs(cuda_device, getattr(torch, dtype), 2, 2, T, D, 3)
    got = fused_rel_scores(qu, qv, k, pos)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (2, 2, T, T)
    want = fused_rel_scores_plain(qu, qv, k, pos)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D", SHAPES)
def test_rel_flash_kernel_matches_plain(cuda_device, dtype, T, D):
    dt = getattr(torch, dtype)
    qu, qv, k, v, pos = _inputs(cuda_device, dt, 3, 2, T, D, 4)
    lens = torch.tensor([T, T // 3, 0], dtype=torch.int32, device=cuda_device)
    got = rel_flash_attention(qu, qv, k, v, pos, kv_lens=lens)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (3, 2, T, D)
    want = rel_flash_attention_plain(qu, qv, k, v, pos, kv_lens=lens)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)
    assert not got[2].any()  # a batch row with no keys returns zeros


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D", SHAPES + REL_SCORES_SHAPES + [(130, 768)])
def test_rel_scores_bwd_kernel_matches_plain(cuda_device, dtype, T, D):
    dt = getattr(torch, dtype)
    qu, qv, k, _, pos = _inputs(cuda_device, dt, 3, 2, T, D, 5)
    g = torch.from_numpy(
        np.random.default_rng(6).standard_normal((3, 2, T, T)).astype(np.float32)
    ).to(cuda_device)
    got = rel_band_bwd(g, qv, pos)
    torch.cuda.synchronize()
    want = rel_band_bwd_plain(g, qv, pos)
    tol = dict(atol=1e-4, rtol=1e-5) if dtype == "float32" else dict(atol=1e-2, rtol=2 ** -7)
    for name, a, b, x in zip(("dq_v", "dpos"), got, want, (qv, pos)):
        assert a.dtype == dt and a.shape == x.shape, name
        np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                                   err_msg=name, **tol)


def test_autograd_on_the_card_goes_through_both_kernels(cuda_device, zero_counts):
    qu, qv, k, _, pos = (t.requires_grad_() for t in _inputs(cuda_device, torch.float32,
                                                               2, 2, 37, 48, 7))
    s = fused_rel_scores(qu, qv, k, pos, bwd="banded")
    assert s.grad_fn is not None
    g = torch.randn_like(s)
    s.backward(g)
    torch.cuda.synchronize()
    assert (fused_rel_scores.launches, rel_band_bwd.launches) == (1, 1)
    want = fused_rel_scores_bwd_plain(g, *(t.detach() for t in (qu, qv, k, pos)))
    for t, w in zip((qu, qv, k, pos), want):
        np.testing.assert_allclose(t.grad.cpu().numpy(), w.cpu().numpy(), atol=1e-4, rtol=1e-5)


def test_each_launch_counts_once(cuda_device, zero_counts):
    qu, qv, k, v, pos = _inputs(cuda_device, torch.float32, 2, 2, 20, 8, 0)
    fused_rel_scores(qu, qv, k, pos)
    rel_flash_attention(qu, qv, k, v, pos)
    rel_flash_attention(qu, qv, k, v, pos)
    torch.cuda.synchronize()
    assert (fused_rel_scores.launches, rel_flash_attention.launches) == (1, 2)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    qu, qv, k, v, pos = _inputs(cuda_device, torch.float32, 1, 2, 16, 8, 0)
    with pytest.raises(TypeError):
        fused_rel_scores(qu.half(), qv.half(), k.half(), pos.half())
    big = [t.new_zeros(1, 2, 4, 1040) for t in (qu, qv, k, v)]
    with pytest.raises(ValueError, match="head dim"):
        rel_flash_attention(*big, pos.new_zeros(2, 7, 1040))


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D", SHAPES)
def test_rel_flash_dropout_and_lse_match_plain(cuda_device, rate, dtype, T, D):
    dt = getattr(torch, dtype)
    qu, qv, k, v, pos = _inputs(cuda_device, dt, 3, 2, T, D, 8)
    lens = torch.tensor([T, T // 3, 0], dtype=torch.int32, device=cuda_device)
    out, lse = fa._fwd(qu, qv, k, v, pos, lens, rate, 99, need_lse=True)
    torch.cuda.synchronize()
    want, want_lse = rel_flash_attention_plain(qu, qv, k, v, pos, lens, rate, 99, return_lse=True)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(), **tol)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(), atol=1e-4, rtol=1e-4)
    assert not out[2].any() and (lse[2] == fa.NEG_INF).all()


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D", SHAPES + [(130, 768)])
def test_rel_flash_bwd_kernels_match_plain(cuda_device, rate, dtype, T, D):
    dt = getattr(torch, dtype)
    qu, qv, k, v, pos = _inputs(cuda_device, dt, 3, 2, T, D, 9)
    lens = torch.tensor([T, T // 3, 0], dtype=torch.int32, device=cuda_device)
    d_out = torch.randn(qu.shape, device=cuda_device,
                        generator=torch.Generator(device=cuda_device).manual_seed(1)).to(dt)
    out, lse = rel_flash_attention_plain(qu, qv, k, v, pos, lens, rate, 5, return_lse=True)
    args = (qu, qv, k, v, pos, lens, lse, fa._delta(out, d_out), d_out, rate, 5)
    for kernel, plain, names in (
        (rel_flash_bwd_dq, fa.rel_flash_bwd_dq_plain, ("dq_u", "dq_v")),
        (rel_flash_bwd_dkv, fa.rel_flash_bwd_dkv_plain, ("dk", "dv")),
        (rel_flash_bwd_dpos, fa.rel_flash_bwd_dpos_plain, ("dpos",)),
    ):
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
        for name, a, b in zip(names, got, want):
            assert a.dtype == dt and a.shape == b.shape, name
            np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                                       err_msg=name, **BWD_TOL[dtype])


def test_flash_autograd_on_the_card_goes_through_the_four_kernels(cuda_device, zero_counts):
    ts = [t.requires_grad_() for t in _inputs(cuda_device, torch.float32, 3, 2, 70, 48, 10)]
    lens = torch.tensor([70, 33, 0], dtype=torch.int32, device=cuda_device)
    out = rel_flash_attention(*ts, kv_lens=lens, dropout_rate=0.2, dropout_seed=17)
    assert out.grad_fn is not None
    g = torch.randn_like(out)
    out.backward(g)
    torch.cuda.synchronize()
    assert [fn.launches for fn in COUNTED] == [0, 0, 1, 1, 1, 1]
    plain_out, lse = rel_flash_attention_plain(*(t.detach() for t in ts), lens, 0.2, 17,
                                               return_lse=True)
    np.testing.assert_allclose(out.detach().cpu().numpy(), plain_out.cpu().numpy(),
                               atol=1e-5, rtol=1e-5)
    want = rel_flash_attention_bwd_plain(*(t.detach() for t in ts), lens, plain_out, lse, g,
                                         0.2, 17)
    for name, t, w in zip(("q_u", "q_v", "k", "v", "pos"), ts, want):
        np.testing.assert_allclose(t.grad.cpu().numpy(), w.cpu().numpy(), err_msg=name,
                                   **BWD_TOL["float32"])


# (Tq, Tk, D): self-attention at the VTN's head dim 96 and at 64, cross
# shapes both ways, and the largest head dim of the DP 256 variants; then
# shapes that cross several 64-row tiles of kernels 9-11 with partial last
# tiles, both ways, a head dim of 128, D 20 (bf16 rows not 16-byte aligned)
# and a single query row against several key tiles; then the AAS-VC
# conformer's selfattn head dims, D 192 (encoder, on the DP 256 variants)
# and D 768 (decoder, the DP 768 variants, the largest they take), with a
# cross shape and D 520 (padded to 768)
STD_SHAPES = [(37, 37, 64), (130, 130, 96), (45, 130, 96), (130, 45, 96), (70, 70, 256),
              (200, 333, 96), (333, 200, 96), (130, 130, 128), (130, 130, 20), (1, 333, 96),
              (130, 130, 192), (70, 70, 768), (200, 133, 768), (45, 70, 520)]


def _std_inputs(device, dtype, Tq, Tk, D, seed, B=3, H=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Tq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, H, Tk, D)).astype(np.float32) for _ in range(2))
    lens = torch.tensor([Tk, Tk // 3, 0], dtype=torch.int32, device=device)
    return [torch.from_numpy(a).to(device, dtype) for a in (q, k, v)] + [lens]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Tq,Tk,D", STD_SHAPES)
def test_flash_kernel_and_lse_match_plain(cuda_device, causal, rate, dtype, Tq, Tk, D):
    dt = getattr(torch, dtype)
    q, k, v, lens = _std_inputs(cuda_device, dt, Tq, Tk, D, 11)
    out, lse = fa._std_fwd(q, k, v, lens, causal, rate, 99, need_lse=True)
    serving = flash_attention(q, k, v, kv_lens=lens, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == dt and out.shape == q.shape
    want, want_lse = flash_attention_plain(q, k, v, lens, causal, rate, 99, return_lse=True)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(), **tol)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(serving.float().cpu().numpy(),
                               flash_attention_plain(q, k, v, lens, causal).float().cpu().numpy(),
                               **tol)
    assert not out[2].any() and (lse[2] == fa.NEG_INF).all()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Tq,Tk,D", STD_SHAPES)
def test_flash_bwd_kernels_match_plain(cuda_device, causal, rate, dtype, Tq, Tk, D):
    dt = getattr(torch, dtype)
    q, k, v, lens = _std_inputs(cuda_device, dt, Tq, Tk, D, 12)
    d_out = torch.randn(q.shape, device=cuda_device,
                        generator=torch.Generator(device=cuda_device).manual_seed(1)).to(dt)
    out, lse = flash_attention_plain(q, k, v, lens, causal, rate, 5, return_lse=True)
    args = (q, k, v, lens, lse, fa._delta(out, d_out), d_out, causal, rate, 5)
    for kernel, plain, names in ((flash_bwd_dq, fa.flash_bwd_dq_plain, ("dq",)),
                                 (flash_bwd_dkv, fa.flash_bwd_dkv_plain, ("dk", "dv"))):
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
        for name, a, b in zip(names, got, want):
            assert a.dtype == dt and a.shape == b.shape, name
            np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                                       err_msg=name, **BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Tq,Tk,D,causal", [(333, 200, 96, False), (200, 333, 256, True),
                                             (133, 200, 768, True)])
def test_flash_bwd_kernels_are_deterministic(cuda_device, dtype, Tq, Tk, D, causal):
    # no atomics: every output element has one owner, so two launches on
    # the same inputs give the same bits
    dt = getattr(torch, dtype)
    q, k, v, lens = _std_inputs(cuda_device, dt, Tq, Tk, D, 14)
    d_out = torch.randn(q.shape, device=cuda_device,
                        generator=torch.Generator(device=cuda_device).manual_seed(2)).to(dt)
    out, lse = flash_attention_plain(q, k, v, lens, causal, 0.1, 6, return_lse=True)
    args = (q, k, v, lens, lse, fa._delta(out, d_out), d_out, causal, 0.1, 6)
    for kernel in (flash_bwd_dq, flash_bwd_dkv):
        first, second = kernel(*args), kernel(*args)
        torch.cuda.synchronize()
        first, second = (x if isinstance(x, tuple) else (x,) for x in (first, second))
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_fwd_and_rel_scores_kernels_are_deterministic(cuda_device, dtype):
    # kernels 9 and 1: no atomics, every output element has one owner, so
    # two launches on the same inputs give the same bits
    dt = getattr(torch, dtype)
    q, k, v, lens = _std_inputs(cuda_device, dt, 333, 200, 96, 15)
    for causal in (False, True):
        first = fa._std_fwd(q, k, v, lens, causal, 0.1, 7, need_lse=True)
        second = fa._std_fwd(q, k, v, lens, causal, 0.1, 7, need_lse=True)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)
    qu, qv, kk, _, pos = _inputs(cuda_device, dt, 2, 2, 200, 192, 16)
    first, second = fused_rel_scores(qu, qv, kk, pos), fused_rel_scores(qu, qv, kk, pos)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,D", [(3, 200, 192), (5, 130, 768)])
def test_rel_scores_bwd_kernels_3_and_5_are_deterministic(cuda_device, dtype, B, T, D):
    # kernels 3 and 5 split the table gradient's batch walk into groups
    # (here B of them, one batch item each) whose float32 sums one cluster
    # adds in rank order: no atomics, so two launches give the same bits
    _, qv, _, _, pos = _inputs(cuda_device, getattr(torch, dtype), B, 2, T, D, 19)
    g = torch.randn(B, 2, T, T, device=cuda_device,
                    generator=torch.Generator(device=cuda_device).manual_seed(20))
    for kernel in (rel_band_bwd, rel_band_bwd_dpos):
        first, second = kernel(g, qv, pos), kernel(g, qv, pos)
        torch.cuda.synchronize()
        first, second = (x if isinstance(x, tuple) else (x,) for x in (first, second))
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_flash_autograd_on_the_card_goes_through_the_three_kernels(cuda_device, zero_counts):
    q, k, v, lens = _std_inputs(cuda_device, torch.float32, 45, 130, 96, 13)
    ts = [t.requires_grad_() for t in (q, k, v)]
    out = flash_attention(*ts, kv_lens=lens, dropout_rate=0.2, dropout_seed=17)
    assert out.grad_fn is not None
    g = torch.randn_like(out)
    out.backward(g)
    torch.cuda.synchronize()
    assert [fn.launches for fn in STD_COUNTED] == [1, 1, 1]
    assert [fn.launches for fn in COUNTED] == [0] * len(COUNTED)
    plain_out, lse = flash_attention_plain(*(t.detach() for t in ts), lens, False, 0.2, 17,
                                           return_lse=True)
    np.testing.assert_allclose(out.detach().cpu().numpy(), plain_out.cpu().numpy(),
                               atol=1e-5, rtol=1e-5)
    want = flash_attention_bwd_plain(*(t.detach() for t in ts), lens, plain_out, lse, g,
                                     False, 0.2, 17)
    for name, t, w in zip(("q", "k", "v"), ts, want):
        np.testing.assert_allclose(t.grad.cpu().numpy(), w.cpu().numpy(), err_msg=name,
                                   **BWD_TOL["float32"])


def test_flash_wrapper_refuses_head_dims_past_256(cuda_device):
    # the kernels take D up to fa.STD_MAX_D (768 since the DP 768 variants)
    q = torch.zeros(1, 2, 8, fa.STD_MAX_D + 8, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)


# ------------------------------ the legacy form: D wide in kernels 2 and 6-8
def _legacy_inputs(device, dtype, B, H, T, D, seed):
    """(q_u, q_v, k, v, pos) of the legacy form, D wide with the (H, T, D)
    table, as every kernel takes them."""
    qu, qv, k, v, _ = _inputs(device, dtype, B, H, T, D, seed)
    pos = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((H, T, D))
                           .astype(np.float32)).to(device, dtype)
    return [qu, qv, k, v, pos]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D", SHAPES + [(130, 768)])
def test_legacy_rel_flash_kernels_match_plain(cuda_device, zero_counts, rate, dtype, T, D):
    dt = getattr(torch, dtype)
    ins = _legacy_inputs(cuda_device, dt, 3, 2, T, D, 14)
    lens = torch.tensor([T, T // 3, 0], dtype=torch.int32, device=cuda_device)
    out, lse = fa._fwd(*ins, lens, rate, 99, need_lse=True, legacy=True)
    want, want_lse = rel_flash_attention_plain(*ins, lens, rate, 99, return_lse=True, legacy=True)
    torch.cuda.synchronize()
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(), **tol)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(), atol=1e-4, rtol=1e-4)
    d_out = torch.randn(out.shape, device=cuda_device,
                        generator=torch.Generator(device=cuda_device).manual_seed(2)).to(dt)
    delta = fa._delta(want, d_out)
    for kernel, plain, names, shapes in (
        (rel_flash_bwd_dq, fa.rel_flash_bwd_dq_plain, ("dq_u", "dq_v"), ins[:2]),
        (rel_flash_bwd_dkv, fa.rel_flash_bwd_dkv_plain, ("dk", "dv"), ins[2:4]),
        (rel_flash_bwd_dpos, fa.rel_flash_bwd_dpos_plain, ("dpos",), ins[4:]),
    ):
        got = kernel(*ins, lens, want_lse, delta, d_out, rate, 5, legacy=True)
        want_g = plain(*ins, lens, want_lse, delta, d_out, rate, 5, legacy=True)
        torch.cuda.synchronize()
        got, want_g = (x if isinstance(x, tuple) else (x,) for x in (got, want_g))
        for name, a, b, x in zip(names, got, want_g, shapes):
            assert a.dtype == dt and a.shape == b.shape == x.shape, name
            np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                                       err_msg=name, **BWD_TOL[dtype])
    # every launch counted as the legacy form's
    assert [fn.launches for fn in LEGACY_COUNTED] == [0] * 4
    assert [fn.legacy_launches for fn in LEGACY_COUNTED] == [1] * 4


# kernels 2 and 6 on the tensor cores (bf16) and in FMA (float32): both head
# dims, both forms, rate 0 and 0.2, key padding and a fully masked row; T
# 200 spans four row blocks and four key tiles, so legacy tiles fall below,
# above and across the diagonal. Tolerances as above.
@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [192, 768])
def test_tensor_core_fwd_and_dq_match_plain(cuda_device, zero_counts, legacy, rate, dtype, D):
    dt, T = getattr(torch, dtype), 200
    ins = (_legacy_inputs(cuda_device, dt, 3, 2, T, D, 18) if legacy
           else _inputs(cuda_device, dt, 3, 2, T, D, 18))
    lens = torch.tensor([T, 77, 0], dtype=torch.int32, device=cuda_device)
    out, lse = fa._fwd(*ins, lens, rate, 41, need_lse=True, legacy=legacy)
    serving = rel_flash_attention(*ins, kv_lens=lens, legacy=legacy)
    want, want_lse = rel_flash_attention_plain(*ins, lens, rate, 41, return_lse=True,
                                               legacy=legacy)
    torch.cuda.synchronize()
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(), **tol)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        serving.float().cpu().numpy(),
        rel_flash_attention_plain(*ins, lens, legacy=legacy).float().cpu().numpy(), **tol)
    assert not out[2].any() and (lse[2] == fa.NEG_INF).all()
    d_out = torch.randn(out.shape, device=cuda_device,
                        generator=torch.Generator(device=cuda_device).manual_seed(3)).to(dt)
    args = (*ins, lens, want_lse, fa._delta(want, d_out), d_out, rate, 41)
    got = rel_flash_bwd_dq(*args, legacy=legacy)
    want_g = fa.rel_flash_bwd_dq_plain(*args, legacy=legacy)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq_u", "dq_v"), got, want_g):
        assert a.dtype == dt and a.shape == b.shape == ins[0].shape, name
        np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                                   err_msg=name, **BWD_TOL[dtype])
    assert not got[0][2].any() and not got[1][2].any()  # no live key, no gradient
    counter = "legacy_launches" if legacy else "launches"
    assert [getattr(fn, counter) for fn in (rel_flash_attention, rel_flash_bwd_dq)] == [2, 1]


# kernels 7 and 8 on the tensor cores (bf16) and in FMA (float32), as
# kernels 2 and 6 above: T 200 spans four 64-query tiles and thirteen
# 16-key (or 16-row) blocks
@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [192, 768])
def test_tensor_core_dkv_and_dpos_match_plain(cuda_device, zero_counts, legacy, rate, dtype, D):
    _check_dkv_and_dpos(cuda_device, legacy, rate, getattr(torch, dtype), 200, D, [200, 77, 0],
                        seed=19)


# the edges: T 1-3 (a legacy hi window of one row or none), T 70 (a multiple
# of neither tile), a key length of 0, dropout on and off
@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 2, 3, 70])
def test_dkv_and_dpos_at_edge_lengths(cuda_device, zero_counts, legacy, dtype, T):
    for rate in (0.0, 0.2):
        _check_dkv_and_dpos(cuda_device, legacy, rate, getattr(torch, dtype), T, 48,
                            [T, max(1, T // 3), 0], seed=T)


def _check_dkv_and_dpos(device, legacy, rate, dt, T, D, lens, seed):
    """Kernels 7 and 8 against their plain versions on the same inputs; a
    batch row with no live key gets dk = dv = 0."""
    ins = (_legacy_inputs(device, dt, 3, 2, T, D, seed) if legacy
           else _inputs(device, dt, 3, 2, T, D, seed))
    lens = torch.tensor(lens, dtype=torch.int32, device=device)
    want, lse = rel_flash_attention_plain(*ins, lens, rate, 43, return_lse=True, legacy=legacy)
    d_out = torch.randn(want.shape, device=device,
                        generator=torch.Generator(device=device).manual_seed(seed)).to(dt)
    args = (*ins, lens, lse, fa._delta(want, d_out), d_out, rate, 43)
    counter = "legacy_launches" if legacy else "launches"
    before = [getattr(fn, counter) for fn in (rel_flash_bwd_dkv, rel_flash_bwd_dpos)]
    got = (*rel_flash_bwd_dkv(*args, legacy=legacy), rel_flash_bwd_dpos(*args, legacy=legacy))
    want_g = (*fa.rel_flash_bwd_dkv_plain(*args, legacy=legacy),
              fa.rel_flash_bwd_dpos_plain(*args, legacy=legacy))
    torch.cuda.synchronize()
    for name, a, b, x in zip(("dk", "dv", "dpos"), got, want_g, ins[2:]):
        assert a.dtype == dt and a.shape == b.shape == x.shape, name
        np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                                   err_msg=f"{name} T {T} rate {rate}", **BWD_TOL[str(dt)[6:]])
    assert not got[0][2].any() and not got[1][2].any()  # no live key, no gradient
    after = [getattr(fn, counter) for fn in (rel_flash_bwd_dkv, rel_flash_bwd_dpos)]
    assert [a - b for a, b in zip(after, before)] == [1, 1]


def test_legacy_flash_autograd_on_the_card_goes_through_the_legacy_kernels(cuda_device,
                                                                           zero_counts,
                                                                           monkeypatch):
    def refuse(*_):
        raise AssertionError("the legacy backward assembled a doubled input")

    monkeypatch.setattr(fa, "legacy_rel_inputs", refuse)
    monkeypatch.setattr(fa, "legacy_dpos", refuse)
    qu, qv, k, v, _ = _inputs(cuda_device, torch.float32, 3, 2, 70, 48, 15)
    pos = torch.randn(2, 70, 48, device=cuda_device)
    ts = [t.requires_grad_() for t in (qu, qv, k, v, pos)]
    lens = torch.tensor([70, 33, 0], dtype=torch.int32, device=cuda_device)
    out = rel_flash_attention(*ts, kv_lens=lens, dropout_rate=0.2, dropout_seed=17, legacy=True)
    g = torch.randn_like(out)
    out.backward(g)
    torch.cuda.synchronize()
    assert [fn.legacy_launches for fn in LEGACY_COUNTED] == [1, 1, 1, 1]
    assert [fn.launches for fn in COUNTED + PAIR_COUNTED] == [0] * 8
    # the same function through the D-wide plain versions
    leaves = [t.detach() for t in ts]
    want_out, lse = rel_flash_attention_plain(*leaves, lens, 0.2, 17, return_lse=True,
                                              legacy=True)
    np.testing.assert_allclose(out.detach().cpu().numpy(), want_out.cpu().numpy(),
                               atol=1e-5, rtol=1e-5)
    want = rel_flash_attention_bwd_plain(*leaves, lens, want_out, lse, g, 0.2, 17, legacy=True)
    for name, t, w in zip(("q_u", "q_v", "k", "v", "pos"), ts, want):
        np.testing.assert_allclose(t.grad.cpu().numpy(), w.cpu().numpy(), err_msg=name,
                                   **BWD_TOL["float32"])


def test_legacy_wrapper_refuses_widths_past_the_kernels(cuda_device):
    big = [torch.zeros(1, 2, 4, 1040, device=cuda_device) for _ in range(4)]
    with pytest.raises(ValueError, match="head dim"):
        rel_flash_attention(*big, torch.zeros(2, 4, 1040, device=cuda_device), legacy=True)


# ------------------------------------ kernels 4 and 5: bwd="pallas"
# past the kernel 3 shapes: each D chunk (64, 128, 192 columns) and two past
# 192 (196: rows not 16-byte aligned in bf16), T 1 and 63 under one 64-row
# tile, and a T past 960 that is not a multiple of 64
PAIR_SHAPES = [(130, 768), (63, 128), (1, 200), (200, 64), (65, 196), (1000, 192)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D", SHAPES + REL_SCORES_SHAPES + PAIR_SHAPES)
def test_rel_scores_pair_kernels_match_plain(cuda_device, zero_counts, dtype, T, D):
    dt = getattr(torch, dtype)
    _, qv, _, _, pos = _inputs(cuda_device, dt, 3, 2, T, D, 16)
    g = torch.from_numpy(
        np.random.default_rng(17).standard_normal((3, 2, T, T)).astype(np.float32)
    ).to(cuda_device)
    got = (rel_band_bwd_dqv(g, qv, pos), rel_band_bwd_dpos(g, qv, pos))
    torch.cuda.synchronize()
    want = (rel_band_bwd_dqv_plain(g, qv, pos), rel_band_bwd_dpos_plain(g, qv, pos))
    tol = dict(atol=1e-4, rtol=1e-5) if dtype == "float32" else dict(atol=1e-2, rtol=2 ** -7)
    for name, a, b, x in zip(("dq_v", "dpos"), got, want, (qv, pos)):
        assert a.dtype == dt and a.shape == x.shape, name
        np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                                   err_msg=name, **tol)
    assert [fn.launches for fn in PAIR_COUNTED] == [1, 1]


def test_pallas_backward_on_the_card_goes_through_kernels_4_and_5(cuda_device, zero_counts):
    qu, qv, k, _, pos = (t.requires_grad_() for t in _inputs(cuda_device, torch.float32,
                                                               2, 2, 37, 48, 18))
    s = fused_rel_scores(qu, qv, k, pos, bwd="pallas")
    g = torch.randn_like(s)
    s.backward(g)
    torch.cuda.synchronize()
    assert (fused_rel_scores.launches, rel_band_bwd.launches) == (1, 0)
    assert [fn.launches for fn in PAIR_COUNTED] == [1, 1]
    want = fused_rel_scores_bwd_plain(g, *(t.detach() for t in (qu, qv, k, pos)))
    for t, w in zip((qu, qv, k, pos), want):
        np.testing.assert_allclose(t.grad.cpu().numpy(), w.cpu().numpy(), atol=1e-4, rtol=1e-5)
