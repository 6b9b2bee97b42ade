"""Port: the D-wide legacy form of the rel-pos flash dk/dv and dpos (kernels
7 and 8) against the JAX package, on the CPU.

The kernels take the legacy form as the module holds it: q_v (B, H, T, D)
and the (H, T, D) table, each band cell reading q_v row i or i+1 and its
table row by the sign of j - i. Their plain versions
(``rel_flash_bwd_dkv_plain`` and ``rel_flash_bwd_dpos_plain`` with
``legacy=True``; the table's adjoint of the band is ``legacy_band_dpos``)
are held here against the JAX kernels at ``legacy=True`` (interpret mode,
block 32, as tests/test_torch_legacy_rel.py runs them) and against the
doubled-width plain path of ``legacy_rel_inputs`` and ``legacy_dpos``, an
independent derivation of the same function that no kernel takes any
more. Also ``legacy_band_dpos`` against autograd's vjp of ``legacy_band``,
and the whole legacy VJP through ``rel_flash_attention_bwd`` on the CPU,
which must assemble no doubled input.

Inputs come from a numpy seed with key-length padding and a fully masked
batch row; the dropout case takes T = 100, where the JAX and the port pads
are both 128 and the masks are the same bits. Tolerances (float32): against
JAX atol 2e-5 and rtol 1e-5, as tests/test_torch_legacy_rel.py (softmax-
weighted sums of at most 100 products in another order); against the
doubled-width plain path atol 1e-5 and rtol 1e-5 (the same sums, the
band's zero half dropped); ``legacy_band_dpos`` against autograd atol 1e-5
and rtol 1e-6 (sums of at most 2T products of order 1 in another order).
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
@pytest.mark.parametrize("kernel", ["dkv", "dpos"])
def test_d_wide_plain_matches_jax_and_the_doubled_path(kernel, T, rate):
    (qu, qv, k, v, pos), lens, g = _torch_inputs(T)
    out, lse = port_flash.rel_flash_attention_plain(qu, qv, k, v, pos, lens, *_drop(rate),
                                                    return_lse=True, legacy=True)
    args = (lens, lse, port_flash._delta(out, g), g, *_drop(rate))
    plain = getattr(port_flash, f"rel_flash_bwd_{kernel}_plain")
    got = plain(qu, qv, k, v, pos, *args, legacy=True)
    got = got if isinstance(got, tuple) else (got,)
    names = ("k", "v") if kernel == "dkv" else ("pos",)
    want = dict(zip(NAMES, _jax_vjp(T, rate)[1]))
    for name, x in zip(names, got):
        assert x.shape == want[name].shape, name
        np.testing.assert_allclose(x.numpy(), want[name], err_msg=name, **TOL)
    # the doubled path, its table gradient mapped back through the assembly
    qv2, table = port_flash.legacy_rel_inputs(qv, pos)
    doubled = plain(qu, qv2, k, v, table, *args)
    if kernel == "dpos":
        doubled = (port_flash.legacy_dpos(doubled),)
    for name, x, y in zip(names, got, doubled):
        np.testing.assert_allclose(x.numpy(), y.numpy(), err_msg=name, **PLAIN_TOL)
    if kernel == "dkv":  # no live key, no gradient
        assert not got[0][2].any() and not got[1][2].any()


@pytest.mark.parametrize("T", [1, 2, 3, 11])
def test_legacy_band_dpos_is_the_band_adjoint(T):
    """The table's cotangent of ``legacy_band``: the lo term, the hi term
    (none for rows p >= T-2 and from the last q_v row), nothing from the
    cells j = i+1."""
    rng = np.random.default_rng(T)
    qv = torch.from_numpy(rng.standard_normal((2, 3, T, 5)).astype(np.float32))
    pos = torch.from_numpy(rng.standard_normal((3, T, 5)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((2, 3, T, T)).astype(np.float32))
    port_flash.legacy_band(qv, pos).backward(g)
    got = port_flash.legacy_band_dpos(g, qv)
    assert got.shape == pos.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, pos.grad, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("T,rate", FLASH_CASES)
def test_legacy_vjp_on_the_cpu_assembles_no_doubled_input(monkeypatch, T, rate):
    """``rel_flash_attention_bwd(legacy=True)`` on CPU tensors: the five
    cotangents against the JAX VJP, with ``legacy_rel_inputs`` and
    ``legacy_dpos`` out of reach."""
    def refuse(*_):
        raise AssertionError("the legacy backward assembled a doubled input")

    monkeypatch.setattr(port_flash, "legacy_rel_inputs", refuse)
    monkeypatch.setattr(port_flash, "legacy_dpos", refuse)
    (qu, qv, k, v, pos), lens, g = _torch_inputs(T)
    out, lse = port_flash.rel_flash_attention_plain(qu, qv, k, v, pos, lens, *_drop(rate),
                                                    return_lse=True, legacy=True)
    grads = port_flash.rel_flash_attention_bwd(qu, qv, k, v, pos, lens, out, lse, g,
                                               *_drop(rate), legacy=True)
    for name, x, w in zip(NAMES, grads, _jax_vjp(T, rate)[1]):
        assert x.shape == w.shape, name
        np.testing.assert_allclose(x.numpy(), w, err_msg=name, **TOL)
