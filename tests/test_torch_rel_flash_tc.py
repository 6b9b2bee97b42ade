"""Port: the D-wide legacy form of the rel-pos flash forward and dq
(kernels 2 and 6) against the JAX package, on the CPU.

The kernels take the legacy form as the module holds it: q_v (B, H, T, D)
and the (H, T, D) table, each band cell reading q_v row i or i+1 and its
table row by the sign of j - i. Their plain versions
(``rel_flash_attention_plain`` and ``rel_flash_bwd_dq_plain`` with
``legacy=True``) compute the legacy ``rel_shift``'s three cases directly;
here they are held against the JAX kernels at ``legacy=True`` (interpret
mode, block 32, as tests/test_torch_legacy_rel.py runs them) and against
the doubled-width plain path of ``legacy_rel_inputs``, the tests' second
derivation of the legacy band. Also the two assembly helpers: the
one-row-shifted dq_v (``shift_legacy_dqv``) and the adjoint that maps the
doubled table's gradient back (``legacy_dpos``), and the whole legacy VJP.
(Kernels 7 and 8: tests/test_torch_rel_flash_bwd_tc.py.)

Inputs come from a numpy seed with key-length padding and a fully masked
batch row; the dropout case takes T = 100, where the JAX and the port pads
are both 128 and the masks are the same bits. Tolerances (float32): against
JAX atol 2e-5 and rtol 1e-5, as tests/test_torch_legacy_rel.py (softmax-
weighted sums of at most 100 products in another order); against the
doubled-width plain path atol 1e-5 and rtol 1e-5 (the same sums, the
band's zero half dropped); the two assembly helpers exactly (they only add
and move elements).
"""

import numpy as np
import pytest
import torch

from _torch_port import release_jax_executables  # noqa: F401 (autouse fixture)
from seq2seq_vc_torch.ops import flash_attention as port_flash
from test_torch_legacy_rel import FLASH_CASES, NAMES, SEED, TOL, _inputs, _jax_vjp

PLAIN_TOL = dict(atol=1e-5, rtol=1e-5)


def _torch_inputs(T):
    arrays, lens, g = _inputs(T)
    return [torch.from_numpy(a) for a in arrays], torch.from_numpy(lens), torch.from_numpy(g)


def _drop(rate):
    return rate, SEED if rate else None


@pytest.mark.parametrize("T,rate", FLASH_CASES)
def test_d_wide_plain_forward_matches_jax_and_the_doubled_path(T, rate):
    (qu, qv, k, v, pos), lens, _ = _torch_inputs(T)
    out, lse = port_flash.rel_flash_attention_plain(qu, qv, k, v, pos, lens, *_drop(rate),
                                                    return_lse=True, legacy=True)
    np.testing.assert_allclose(out.numpy(), _jax_vjp(T, rate)[0], **TOL)
    qv2, table = port_flash.legacy_rel_inputs(qv, pos)
    want, want_lse = port_flash.rel_flash_attention_plain(qu, qv2, k, v, table, lens,
                                                          *_drop(rate), return_lse=True)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **PLAIN_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **PLAIN_TOL)
    assert not out[2].any() and (lse[2] == port_flash.NEG_INF).all()


@pytest.mark.parametrize("T,rate", FLASH_CASES)
def test_d_wide_plain_dq_matches_jax_and_the_doubled_path(T, rate):
    (qu, qv, k, v, pos), lens, g = _torch_inputs(T)
    out, lse = port_flash.rel_flash_attention_plain(qu, qv, k, v, pos, lens, *_drop(rate),
                                                    return_lse=True, legacy=True)
    args = (lens, lse, port_flash._delta(out, g), g, *_drop(rate))
    dq_u, dq_v = port_flash.rel_flash_bwd_dq_plain(qu, qv, k, v, pos, *args, legacy=True)
    assert dq_v.shape == qv.shape
    want = _jax_vjp(T, rate)[1]
    np.testing.assert_allclose(dq_u.numpy(), want[0], err_msg="dq_u", **TOL)
    np.testing.assert_allclose(dq_v.numpy(), want[1], err_msg="dq_v", **TOL)
    # the doubled path, its dq_v mapped back through the assembly
    qv_leaf = qv.clone().requires_grad_()
    qv2, table = port_flash.legacy_rel_inputs(qv_leaf, pos)
    dq_u2, dq_v2 = port_flash.rel_flash_bwd_dq_plain(qu, qv2.detach(), k, v, table, *args)
    qv2.backward(dq_v2)
    np.testing.assert_allclose(dq_u.numpy(), dq_u2.numpy(), **PLAIN_TOL)
    np.testing.assert_allclose(dq_v.numpy(), qv_leaf.grad.numpy(), **PLAIN_TOL)


def test_legacy_band_has_the_three_cases():
    T, D = 9, 4
    qv = torch.randn(2, 1, T, D)
    pos = torch.randn(1, T, D)
    band = port_flash.legacy_band(qv, pos)
    for i in range(T):
        for j in range(T):
            if j <= i:
                want = qv[:, 0, i] @ pos[0, T - 1 - (i - j)]
            elif j == i + 1:
                want = torch.zeros(2)
            else:
                want = qv[:, 0, i + 1] @ pos[0, j - i - 2]
            torch.testing.assert_close(band[:, 0, i, j], want, rtol=1e-6, atol=1e-6)


def test_shift_legacy_dqv_moves_hi_one_row_down():
    lo, hi = torch.randn(2, 3, 7, 5), torch.randn(2, 3, 7, 5)
    got = port_flash.shift_legacy_dqv(lo, hi)
    torch.testing.assert_close(got[:, :, 0], lo[:, :, 0], rtol=0, atol=0)
    torch.testing.assert_close(got[:, :, 1:], lo[:, :, 1:] + hi[:, :, :-1], rtol=0, atol=0)
    # the halves' definition: hi[i] carries the cells j >= i + 2 to q_v row i + 1
    T, D = 6, 3
    g = torch.randn(1, 1, T, T)
    pos = torch.randn(1, T, D)
    qv = torch.randn(1, 1, T, D, requires_grad=True)
    port_flash.legacy_band(qv, pos).backward(g)
    torch.testing.assert_close(port_flash.shift_legacy_dqv(*port_flash.legacy_band_dqv(g, pos)),
                               qv.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T", [1, 2, 3, 11])
def test_legacy_dpos_is_the_assembly_adjoint(T):
    D = 4
    pos = torch.randn(2, T, D, requires_grad=True)
    _, table = port_flash.legacy_rel_inputs(torch.randn(1, 2, T, D), pos)
    dtable = torch.randn(table.shape)
    table.backward(dtable)
    got = port_flash.legacy_dpos(dtable)
    assert got.shape == pos.shape
    torch.testing.assert_close(got, pos.grad, rtol=0, atol=0)


@pytest.mark.parametrize("T,rate", FLASH_CASES)
def test_d_wide_legacy_vjp_matches_jax(T, rate):
    """The whole legacy VJP through the wrappers' CPU paths: the D-wide
    forward and backward (dq, dk/dv and dpos)."""
    (qu, qv, k, v, pos), lens, g = _torch_inputs(T)
    ts = [t.clone().requires_grad_() for t in (qu, qv, k, v, pos)]
    out = port_flash.rel_flash_attention(*ts, kv_lens=lens, dropout_rate=rate,
                                         dropout_seed=SEED if rate else None, legacy=True)
    out.backward(g)
    want_out, want = _jax_vjp(T, rate)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    for name, t, w in zip(NAMES, ts, want):
        np.testing.assert_allclose(t.grad.numpy(), w, err_msg=name, **TOL)
