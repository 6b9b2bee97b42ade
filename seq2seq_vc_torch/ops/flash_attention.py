"""Flash attention, forward and backward, as ``torch.autograd.Function``s:
standard multi-head attention (``flash_attention``) and attention with
new-style relative position scores (``rel_flash_attention``).

``flash_attention`` computes ``dropout(softmax(q k^T / sqrt(D))) v`` with a
key-length mask and an optional causal mask, for (B, H, Tq, D) queries and
(B, H, Tk, D) keys (Tq and Tk may differ), online, without materialising
the (Tq, Tk) scores:

- forward: on a CUDA tensor the Hopper kernel in ``csrc/flash.cu`` (with
  in-kernel dropout and, under autograd, the saved logsumexp), on a CPU
  tensor ``flash_attention_plain``;
- backward: on a CUDA tensor the two kernels of ``csrc/flash_bwd.cu``
  (``flash_bwd_dq``, ``flash_bwd_dkv``), on a CPU tensor
  ``flash_attention_bwd_plain``.

``rel_flash_attention`` computes ``dropout(softmax((q_u k^T +
rel_shift(q_v pos^T)) / sqrt(D))) v`` with a key-length mask, in the
new-style or (``legacy=True``) the legacy relative-position form:

- forward: on a CUDA tensor the Hopper kernel in ``csrc/rel_flash.cu``, on a
  CPU tensor ``rel_flash_attention_plain``;
- backward (FlashAttention-2 style: the score tiles are recomputed from
  q, k, the table and the saved logsumexp): on a CUDA tensor the three
  tensor-core kernels of ``csrc/rel_flash_bwd_dq.cu`` (``rel_flash_bwd_dq``),
  ``csrc/rel_flash_bwd_dkv.cu`` (``rel_flash_bwd_dkv``) and
  ``csrc/rel_flash_bwd_dpos.cu`` (``rel_flash_bwd_dpos``), on a CPU tensor
  their plain versions.

Every kernel takes the legacy form D wide, as the module holds it: q_v (B,
H, T, D) and the (H, T, D) table, each band cell reading q_v row i or i+1
and its table row by the sign of j - i (``legacy_band``; its adjoints
``legacy_band_dqv`` and ``legacy_band_dpos``). Nothing doubled is
assembled: ``legacy_rel_inputs`` and ``legacy_dpos``, the doubled-width
derivation of the same function, serve the tests only.

Dropout acts on the *normalised* weights with 1/(1-rate) scaling (the
softmax's row sum is taken before the drop), torch-style. Its keep mask is
a counter-based hash (murmur3 finaliser) of the score element's index
``(bh * tq_pad + i) * tk_pad + j`` with ``tq_pad = round_up(Tq, 128)`` and
``tk_pad = round_up(Tk, 128)``: the same bits as the JAX package's kernels
(seq2seq_vc_tpu/ops/flash_attention.py ``_mix_bits``, ``_keep_from_bits``),
which run with the default blocks of 128. The forward and every backward
kernel draw the same mask; the port's own tile sizes never enter the index.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import native
from .rel_scores import (
    DTYPE_CODES,
    _check_device,
    _check_inputs,
    _score_side_grads,
    fused_rel_scores_plain,
    rel_band_bwd_dpos_plain,
    rel_band_bwd_dqv_plain,
    rel_band_bwd_plain,
)

NEG_INF = -1e30  # finite mask value, as in the JAX kernels
# the JAX entry's default block: the dropout index runs over rows and keys
# padded to a multiple of it
DROPOUT_BLOCK = 128
STD_MAX_D = 768  # head dims the standard kernels take (csrc/flash.cu, flash_bwd.cu)
REL_MAX_D = 1024  # head dims the rel-pos flash kernels take (csrc/rel_flash*.cu)
_M32 = 0xFFFFFFFF

_c = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float


# ------------------------------------------------------------ dropout hash
def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of x * c for int64 ``x`` in [0, 2^32) and a 32-bit
    constant ``c``, in two halves so that no int64 product overflows."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def mix_bits(idx: torch.Tensor, seed) -> torch.Tensor:
    """murmur3 finaliser over a seeded element counter, in uint32 wrapping
    arithmetic carried by int64 tensors (values in [0, 2^32))."""
    x = (_mul32(idx & _M32, 0x9E3779B1) + (int(seed) & _M32)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keep_from_bits(bits: torch.Tensor, rate: float) -> torch.Tensor:
    """The top 24 bits as a uniform float32 in [0, 1), kept where >= rate."""
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u >= torch.tensor(rate, dtype=torch.float32)


def keep_mask(seed, bh, rows, cols, tq: int, tk: int, rate: float) -> torch.Tensor:
    """Keep mask of the score elements at the broadcast int64 index tensors
    (bh, rows, cols): their index is (bh * tq + rows) * tk + cols, taken
    modulo 2^32 (the JAX package's ``_keep_block``)."""
    return keep_from_bits(mix_bits((bh * tq + rows) * tk + cols, seed), rate)


def _keep_mask(seed, n_bh: int, n_rows: int, n_cols: int, tq: int, tk: int, rate: float,
               device=None) -> torch.Tensor:
    """(n_bh, n_rows, n_cols) keep mask from element (0, 0, 0) on."""
    bh, rows, cols = (torch.arange(n, dtype=torch.int64, device=device) for n in (n_bh, n_rows, n_cols))
    return keep_mask(seed, bh[:, None, None], rows[None, :, None], cols[None, None, :], tq, tk,
                     rate)


def dense_dropout_keep(seed, n_bh: int, tq: int, tk: int, rate: float, device=None):
    """(n_bh, tq, tk) keep mask equal to the in-kernel mask (the JAX
    package's ``dense_dropout_keep``): ``tq``/``tk`` are the padded lengths."""
    return _keep_mask(seed, n_bh, tq, tk, tq, tk, rate, device)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _dropout(p, rate: float, seed):
    """p (B, H, Tq, Tk) -> the kept weights scaled by 1/(1-rate) in float32."""
    if rate <= 0.0:
        return p
    B, H, Tq, Tk = p.shape
    tq, tk = _round_up(Tq, DROPOUT_BLOCK), _round_up(Tk, DROPOUT_BLOCK)
    keep = _keep_mask(seed, B * H, Tq, Tk, tq, tk, rate, p.device).view(B, H, Tq, Tk)
    return torch.where(keep, p * _keep_scale(rate), 0.0)


def _keep_scale(rate: float) -> float:
    """1/(1-rate), rounded to float32 as the kernels use it."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


# ------------------------------------------------------- plain versions
def _kv_lens(kv_lens, B, T, device):
    if kv_lens is None:
        return torch.full((B,), T, dtype=torch.int32, device=device)
    if tuple(kv_lens.shape) != (B,):
        raise ValueError(f"kv_lens: expected shape ({B},), got {tuple(kv_lens.shape)}")
    return kv_lens.to(device=device, dtype=torch.int32)


def _valid(lens, T, device, Tq=None, causal=False):
    """(B, 1, 1 or Tq, T) whether key j lies below its batch row's length
    (and, ``causal``, at or before query row i)."""
    valid = (torch.arange(T, device=device)[None, :] < lens[:, None])[:, None, None, :]
    if causal:
        valid = valid & (torch.arange(T, device=device)[None, :]
                         <= torch.arange(Tq, device=device)[:, None])
    return valid


def legacy_band(q_v, pos):
    """The legacy ``rel_shift``'s band, (B, H, T, T) float32, from its three
    cases computed directly (q_v: (B, H, T, D); pos: (H, T, D), row p <->
    absolute position p):

        bd[i, j] = q_v[i]   . pos[T-1-(i-j)]   for j <= i
        bd[i, j] = 0                           for j == i + 1
        bd[i, j] = q_v[i+1] . pos[j-i-2]       for j >= i + 2
    """
    B, H, T, _ = q_v.shape
    raw = torch.einsum("bhqd,hpd->bhqp", q_v.float(), pos.float())  # (B, H, T, T)
    raw_next = F.pad(raw[:, :, 1:], (0, 0, 0, 1))  # row i: q_v[i+1]
    i = torch.arange(T, device=q_v.device)[:, None]
    j = torch.arange(T, device=q_v.device)[None, :]
    lo = torch.gather(raw, 3, (T - 1 - i + j).clamp(0, T - 1).expand(B, H, T, T))
    hi = torch.gather(raw_next, 3, (j - i - 2).clamp(0, T - 1).expand(B, H, T, T))
    return torch.where(j <= i, lo, torch.where(j >= i + 2, hi, 0.0))


def legacy_band_dqv(g, pos):
    """The legacy band's q_v cotangent in two halves, (lo, hi), both (B, H,
    T, D) float32, from the (B, H, T, T) band cotangent ``g``:

        lo[i] = sum_{j <= i}   g[i, j] pos[T-1-i+j]   (q_v row i's)
        hi[i] = sum_{j >= i+2} g[i, j] pos[j-i-2]     (q_v row i+1's)

    ``shift_legacy_dqv(lo, hi)`` adds them into dq_v."""
    B, H, T, _ = g.shape
    i = torch.arange(T, device=g.device)[:, None]
    p = torch.arange(T, device=g.device)[None, :]
    j_lo, j_hi = p + i - (T - 1), p + i + 2  # the key of table row p in each case
    g = g.float()
    d_lo = torch.gather(g, 3, j_lo.clamp(0, T - 1).expand(B, H, T, T)) * (j_lo >= 0)
    d_hi = torch.gather(g, 3, j_hi.clamp(0, T - 1).expand(B, H, T, T)) * (j_hi < T)
    return (torch.einsum("bhip,hpd->bhid", d_lo, pos.float()),
            torch.einsum("bhip,hpd->bhid", d_hi, pos.float()))


def legacy_band_dpos(g, q_v):
    """The legacy band's table cotangent, (H, T, D) float32, from the (B, H,
    T, T) band cotangent ``g``, summed over the batch (the adjoint of
    ``legacy_band`` in ``pos``, as ``legacy_band_dqv`` is in ``q_v``):

        dpos[p] = sum_b sum_i g[i, i+p-(T-1)] q_v[i]     (j <= i: "lo")
                + sum_b sum_i g[i, i+p+2]     q_v[i+1]   (j >= i+2: "hi")

    the hi term only where the key i+p+2 and the row i+1 lie below T."""
    B, H, T, _ = g.shape
    i = torch.arange(T, device=g.device)[:, None]
    p = torch.arange(T, device=g.device)[None, :]
    j_lo, j_hi = p + i - (T - 1), p + i + 2  # the key of table row p in each case
    g = g.float()
    d_lo = torch.gather(g, 3, j_lo.clamp(0, T - 1).expand(B, H, T, T)) * (j_lo >= 0)
    d_hi = torch.gather(g, 3, j_hi.clamp(0, T - 1).expand(B, H, T, T)) * (j_hi < T)
    q_next = F.pad(q_v[:, :, 1:], (0, 0, 0, 1)).float()
    return (torch.einsum("bhip,bhid->hpd", d_lo, q_v.float())
            + torch.einsum("bhip,bhid->hpd", d_hi, q_next))


def shift_legacy_dqv(lo, hi):
    """dq_v = lo + hi moved down one row: the contributions in ``hi[i]``
    belong to q_v row i + 1 (the last row's are zero: no key lies past
    T)."""
    return lo + F.pad(hi[:, :, :-1], (0, 0, 1, 0))


def _scores(q_u, q_v, k, pos, legacy: bool):
    """The (B, H, T, T) float32 scores, scaled, in either form."""
    if not legacy:
        return fused_rel_scores_plain(q_u, q_v, k, pos)
    ac = torch.einsum("bhqd,bhkd->bhqk", q_u.float(), k.float())
    return (ac + legacy_band(q_v, pos)) / math.sqrt(q_u.shape[-1])


def rel_flash_attention_plain(q_u, q_v, k, v, pos, kv_lens=None, dropout_rate: float = 0.0,
                              dropout_seed=None, return_lse: bool = False,
                              legacy: bool = False):
    """Plain PyTorch version of the forward kernel (float32 arithmetic).
    ``legacy``: q_v (B, H, T, D) and the (H, T, D) table of the legacy form
    (``legacy_band``); otherwise the new style, whose q_v and table may be
    wider than the head dim D (the doubled legacy inputs of
    ``legacy_rel_inputs``).

    Returns the (B, H, T, D) context in the input dtype and, with
    ``return_lse``, the (B, H, T) float32 logsumexp of each row's scores
    (``-1e30`` for a row with no live key, whose context is zeros)."""
    B, H, T, _ = q_u.shape
    valid = _valid(_kv_lens(kv_lens, B, T, q_u.device), T, q_u.device)
    return _attend(_scores(q_u, q_v, k, pos, legacy), valid, v, dropout_rate, dropout_seed,
                   q_u.dtype, return_lse)


def _attend(s, valid, v, rate: float, seed, dtype, return_lse: bool):
    """The plain forwards' shared tail: the masked softmax of the float32
    (scaled) scores ``s``, dropout on the normalised weights, times v. The
    context in ``dtype`` and, with ``return_lse``, the (B, H, Tq) logsumexp
    (``-1e30`` for a row with no live key, whose context is zeros)."""
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.matmul(_dropout(p, rate, seed), v.float()) / torch.where(l == 0, 1.0, l)
    out = out.to(dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-37)), NEG_INF)
    return out, lse[..., 0]


def _tile_grads(s, valid, v, lse, delta, d_out, rate: float, seed):
    """The plain backwards' recomputed tiles, whole, from the float32
    (scaled) scores ``s``: (kept weights pd, the scaled scores' cotangent
    ds), both (B, H, Tq, Tk) float32, as the JAX package's
    ``_std_block_grads`` and ``_rel_block_grads`` before their scale."""
    p = torch.where(valid, torch.exp(s - lse.float()[..., None]), 0.0)
    dp = torch.matmul(d_out.float(), v.float().transpose(-1, -2))
    delta = delta.float()[..., None]
    if rate > 0.0:
        pd = _dropout(p, rate, seed)
        return pd, pd * dp - p * delta
    return p, p * (dp - delta)


def _recompute(q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out, rate, seed, legacy=False):
    """The rel-pos backward's (pd, ds before the 1/sqrt(D) scale)."""
    B, H, T, _ = q_u.shape
    valid = _valid(_kv_lens(kv_lens, B, T, q_u.device), T, q_u.device)
    return _tile_grads(_scores(q_u, q_v, k, pos, legacy), valid, v, lse, delta, d_out, rate,
                       seed)


def _delta(out, d_out):
    """rowsum(dO * O) in float32: (B, H, T)."""
    return (d_out.float() * out.float()).sum(-1)


def _rsqrt_d(q_u) -> float:
    """The scores' scale 1/sqrt(D), D the head dim (not the q_v width)."""
    return 1.0 / math.sqrt(q_u.shape[-1])


def rel_flash_bwd_dq_plain(q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out,
                           dropout_rate=0.0, dropout_seed=None, legacy: bool = False):
    """Plain version of the dq kernel: (dq_u, dq_v) in the dtypes of q_u, q_v;
    ``legacy`` as in ``rel_flash_attention_plain`` (dq_v then D wide)."""
    _, ds = _recompute(q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out, dropout_rate,
                       dropout_seed, legacy)
    dq_u = (torch.matmul(ds, k.float()) * _rsqrt_d(q_u)).to(q_u.dtype)
    if legacy:
        dq_v = shift_legacy_dqv(*legacy_band_dqv(ds * _rsqrt_d(q_u), pos))
        return dq_u, dq_v.to(q_v.dtype)
    return dq_u, rel_band_bwd_dqv_plain(ds, q_v, pos, _rsqrt_d(q_u))


def rel_flash_bwd_dkv_plain(q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out,
                            dropout_rate=0.0, dropout_seed=None, legacy: bool = False):
    """Plain version of the dk/dv kernel: (dk, dv) in the dtypes of k, v;
    ``legacy`` as in ``rel_flash_attention_plain``."""
    pd, ds = _recompute(q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out, dropout_rate,
                        dropout_seed, legacy)
    dk = (torch.matmul(ds.transpose(-1, -2), q_u.float()) * _rsqrt_d(q_u)).to(k.dtype)
    dv = torch.matmul(pd.transpose(-1, -2), d_out.float())
    return dk, dv.to(v.dtype)


def _band_dpos(ds, q_v, pos, scale, legacy: bool):
    """The table gradient in pos's dtype from the unscaled ``ds``."""
    if legacy:
        return legacy_band_dpos(ds * scale, q_v).to(pos.dtype)
    return rel_band_bwd_dpos_plain(ds, q_v, pos, scale)


def rel_flash_bwd_dpos_plain(q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out,
                             dropout_rate=0.0, dropout_seed=None, legacy: bool = False):
    """Plain version of the dpos kernel: the table gradient in pos's shape,
    (H, 2T-1, QW) or, ``legacy``, (H, T, D) (``legacy_band_dpos``)."""
    _, ds = _recompute(q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out, dropout_rate,
                       dropout_seed, legacy)
    return _band_dpos(ds, q_v, pos, _rsqrt_d(q_u), legacy)


def rel_flash_attention_bwd_plain(q_u, q_v, k, v, pos, kv_lens, out, lse, d_out,
                                  dropout_rate: float = 0.0, dropout_seed=None,
                                  legacy: bool = False):
    """Plain PyTorch version of the whole backward (float32 arithmetic):
    (dq_u, dq_v, dk, dv, dpos) in the dtypes of (q_u, q_v, k, v, pos), from
    the forward's output ``out`` and logsumexp ``lse`` and the output's
    cotangent ``d_out``; ``legacy`` as in ``rel_flash_attention_plain``."""
    pd, ds = _recompute(q_u, q_v, k, v, pos, kv_lens, lse, _delta(out, d_out), d_out,
                        dropout_rate, dropout_seed, legacy)
    scale = _rsqrt_d(q_u)
    dq_u, dk = _score_side_grads(ds, q_u, k, scale)
    dv = torch.matmul(pd.transpose(-1, -2), d_out.float()).to(v.dtype)
    if legacy:
        dq_v = shift_legacy_dqv(*legacy_band_dqv(ds * scale, pos)).to(q_v.dtype)
        return dq_u, dq_v, dk, dv, _band_dpos(ds, q_v, pos, scale, legacy)
    dq_v, dpos = rel_band_bwd_plain(ds, q_v, pos, scale)
    return dq_u, dq_v, dk, dv, dpos


# -------------------------------------------------------------- kernels
def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name, D):
    """Raise on head dims the rel-pos kernels do not take."""
    if D > REL_MAX_D:
        raise ValueError(f"{name}: head dim {D} > {REL_MAX_D} not supported")


def _dropout_args(rate: float, seed, *lengths: int):
    """(rate, 1/(1-rate), seed as uint32, then each length padded for the
    hash index) as the kernels take them."""
    keep_scale = _keep_scale(rate) if rate > 0.0 else 1.0
    return (_f(rate), _f(keep_scale), ctypes.c_uint32(int(seed or 0) & _M32),
            *(_round_up(t, DROPOUT_BLOCK) for t in lengths))


def _count(wrapper, legacy: bool) -> None:
    """Count one launch of ``wrapper``'s kernel: in ``launches`` in the new
    style, in ``legacy_launches`` in the legacy form."""
    if legacy:
        wrapper.legacy_launches += 1
    else:
        wrapper.launches += 1


def _fwd(q_u, q_v, k, v, pos, lens, rate, seed, need_lse, legacy=False):
    """Forward: kernel 2 on a CUDA tensor, the plain version on a CPU one.
    Returns (out, lse or None)."""
    if q_u.device.type == "cpu":
        out = rel_flash_attention_plain(q_u, q_v, k, v, pos, lens, rate, seed, need_lse, legacy)
        return out if need_lse else (out, None)
    B, H, T, _ = q_u.shape
    out = torch.empty_like(q_u, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q_u.device) if need_lse else None
    _fwd_launch(q_u, q_v, k, v, pos, lens, out, lse, rate, seed, legacy)
    _count(rel_flash_attention, legacy)
    return out, lse


def _fwd_launch(q_u, q_v, k, v, pos, lens, out, lse, rate, seed, legacy=False):
    """One forward kernel launch into ``out`` (and ``lse`` unless None)."""
    B, H, T, D = q_u.shape
    _check_cuda("rel_flash_attention", D)
    qu, qv, kc, vc, pc = (t.contiguous() for t in (q_u, q_v, k, v, pos))
    fn = native.load("rel_flash").rel_flash_fwd
    fn.restype = _i
    fn.argtypes = [_i, _c, _c, _c, _c, _c, _c, _c, _c, _i, _i, _i, _i, _i, _f,
                   _f, _f, ctypes.c_uint32, _i, _c]
    with torch.cuda.device(q_u.device):
        rc = fn(
            DTYPE_CODES[q_u.dtype], qu.data_ptr(), qv.data_ptr(), kc.data_ptr(),
            vc.data_ptr(), pc.data_ptr(), lens.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B * H, H, T, D, int(legacy), _rsqrt_d(q_u), *_dropout_args(rate, seed, T),
            _stream(q_u),
        )
    native.check(rc, "rel_flash_fwd")


def _bwd_launch(symbol, q_u, q_v, k, v, pos, lens, lse, delta, d_out, outs, rate, seed,
                legacy: bool):
    """One backward kernel launch: the argument list shared by the C
    functions of ``csrc/<symbol>.cu``, with ``outs`` (outputs and scratch)
    after the inputs."""
    B, H, T, D = q_u.shape
    _check_cuda(symbol, D)
    ins = [t.contiguous() for t in (q_u, q_v, k, v, pos, lens, lse, delta, d_out)]
    fn = getattr(native.load(symbol), symbol)
    fn.restype = _i
    fn.argtypes = ([_i] + [_c] * (len(ins) + len(outs))
                   + [_i, _i, _i, _i, _i, _f, _f, _f, ctypes.c_uint32, _i, _c])
    with torch.cuda.device(q_u.device):
        rc = fn(
            DTYPE_CODES[q_u.dtype],
            *(None if t is None else t.data_ptr() for t in ins + list(outs)),
            B, H, T, D, int(legacy), _rsqrt_d(q_u), *_dropout_args(rate, seed, T), _stream(q_u),
        )
    native.check(rc, symbol)


def _bwd_inputs(name, q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out, legacy=False):
    B, H, T, D = q_u.shape
    _check_inputs(name, (q_u, q_v, k, v, pos, d_out),
                  ((B, H, T, D),) * 4 + ((H, T if legacy else 2 * T - 1, D), (B, H, T, D)))
    for t, what in ((lse, "lse"), (delta, "delta")):
        if tuple(t.shape) != (B, H, T):
            raise ValueError(f"{name}: {what} must be {(B, H, T)}, got {tuple(t.shape)}")
    _check_device(name, q_u)
    return (_kv_lens(kv_lens, B, T, q_u.device).contiguous(), lse.float(), delta.float())


def rel_flash_bwd_dq(q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out,
                     dropout_rate: float = 0.0, dropout_seed=None, legacy: bool = False):
    """(dq_u, dq_v): on a CUDA tensor kernel 6 of ``csrc/rel_flash_bwd_dq.cu``
    (one launch), on a CPU tensor ``rel_flash_bwd_dq_plain``. ``lse`` and
    ``delta = rowsum(dO * O)`` are (B, H, T) float32. ``legacy``: q_v (B, H,
    T, D) and the (H, T, D) table of the legacy form; the kernel then writes
    dq_v's two halves in float32 (``legacy_band_dqv``) and
    ``shift_legacy_dqv`` adds them."""
    lens, lse, delta = _bwd_inputs("rel_flash_bwd_dq", q_u, q_v, k, v, pos, kv_lens, lse,
                                   delta, d_out, legacy)
    args = (q_u, q_v, k, v, pos, lens, lse, delta, d_out)
    if q_u.device.type == "cpu":
        return rel_flash_bwd_dq_plain(*args, dropout_rate, dropout_seed, legacy)
    dq_u = torch.empty_like(q_u, memory_format=torch.contiguous_format)
    if legacy:
        lo, hi = (torch.empty(q_v.shape, dtype=torch.float32, device=q_v.device)
                  for _ in range(2))
        outs = (dq_u, lo, hi)
    else:
        outs = (dq_u, torch.empty_like(q_v, memory_format=torch.contiguous_format), None)
    _bwd_launch("rel_flash_bwd_dq", *args, outs, dropout_rate, dropout_seed, legacy)
    _count(rel_flash_bwd_dq, legacy)
    if legacy:
        return dq_u, shift_legacy_dqv(lo, hi).to(q_v.dtype)
    return dq_u, outs[1]


def rel_flash_bwd_dkv(q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out,
                      dropout_rate: float = 0.0, dropout_seed=None, legacy: bool = False):
    """(dk, dv): on a CUDA tensor kernel 7 of ``csrc/rel_flash_bwd_dkv.cu``
    (one launch), on a CPU tensor ``rel_flash_bwd_dkv_plain``. Arguments as
    ``rel_flash_bwd_dq``'s."""
    lens, lse, delta = _bwd_inputs("rel_flash_bwd_dkv", q_u, q_v, k, v, pos, kv_lens, lse,
                                   delta, d_out, legacy)
    args = (q_u, q_v, k, v, pos, lens, lse, delta, d_out)
    if q_u.device.type == "cpu":
        return rel_flash_bwd_dkv_plain(*args, dropout_rate, dropout_seed, legacy)
    dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format) for t in (k, v))
    _bwd_launch("rel_flash_bwd_dkv", *args, (dk, dv), dropout_rate, dropout_seed, legacy)
    _count(rel_flash_bwd_dkv, legacy)
    return dk, dv


def rel_flash_bwd_dpos(q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out,
                       dropout_rate: float = 0.0, dropout_seed=None, legacy: bool = False):
    """The table gradient dpos in pos's shape: on a CUDA tensor kernel 8 of
    ``csrc/rel_flash_bwd_dpos.cu`` (per-batch-group partial sums and a
    fixed-order second pass in the same call: deterministic, no atomics), on
    a CPU tensor ``rel_flash_bwd_dpos_plain``. Arguments as
    ``rel_flash_bwd_dq``'s."""
    lens, lse, delta = _bwd_inputs("rel_flash_bwd_dpos", q_u, q_v, k, v, pos, kv_lens, lse,
                                   delta, d_out, legacy)
    args = (q_u, q_v, k, v, pos, lens, lse, delta, d_out)
    if q_u.device.type == "cpu":
        return rel_flash_bwd_dpos_plain(*args, dropout_rate, dropout_seed, legacy)
    dpos = torch.empty_like(pos, memory_format=torch.contiguous_format)
    groups = native.load("rel_flash_bwd_dpos").rel_flash_bwd_dpos_groups
    groups.restype, groups.argtypes = _i, [_i]
    partial = torch.empty((groups(q_u.shape[0]), *pos.shape), dtype=torch.float32,
                          device=q_u.device)
    _bwd_launch("rel_flash_bwd_dpos", *args, (dpos, partial), dropout_rate, dropout_seed,
                legacy)
    _count(rel_flash_bwd_dpos, legacy)
    return dpos


def rel_flash_attention_bwd(q_u, q_v, k, v, pos, kv_lens, out, lse, d_out,
                            dropout_rate: float = 0.0, dropout_seed=None, legacy: bool = False):
    """(dq_u, dq_v, dk, dv, dpos): on a CUDA tensor kernels 6, 7 and 8, on a
    CPU tensor ``rel_flash_attention_bwd_plain``. ``legacy``: q_v and pos as
    the legacy form holds them (D wide, an (H, T, D) table), as every kernel
    takes them."""
    if q_u.device.type == "cpu":
        return rel_flash_attention_bwd_plain(q_u, q_v, k, v, pos, kv_lens, out, lse, d_out,
                                             dropout_rate, dropout_seed, legacy)
    delta, d_out = _delta(out, d_out), d_out.contiguous()
    args = (q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out, dropout_rate, dropout_seed)
    return (*rel_flash_bwd_dq(*args, legacy=legacy), *rel_flash_bwd_dkv(*args, legacy=legacy),
            rel_flash_bwd_dpos(*args, legacy=legacy))


class _RelFlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_u, q_v, k, v, pos, lens, rate, seed, legacy):
        out, lse = _fwd(q_u, q_v, k, v, pos, lens, rate, seed, need_lse=True, legacy=legacy)
        ctx.save_for_backward(q_u, q_v, k, v, pos, lens, out, lse)
        ctx.rate, ctx.seed, ctx.legacy = rate, seed, legacy
        return out

    @staticmethod
    def backward(ctx, d_out):
        q_u, q_v, k, v, pos, lens, out, lse = ctx.saved_tensors
        grads = rel_flash_attention_bwd(q_u, q_v, k, v, pos, lens, out, lse, d_out,
                                        ctx.rate, ctx.seed, ctx.legacy)
        return (*grads, None, None, None, None)


def legacy_rel_inputs(q_v, pos):
    """The legacy form's doubled (q_v2, table): the JAX package's assembly in
    ``rel_flash_attention``, without its padding. No kernel takes it; the
    tests hold the D-wide legacy band against it, a second, independent
    derivation of the same function: the legacy ``rel_shift``
    (``legacy_band``) is one band product of q_v2 = [q_v[i], q_v[i+1]] (B,
    H, T, 2D) with a (H, 2T-1, 2D) table in the new style's row order (row
    p <-> distance T-1-p): columns [0, D) hold pos[0 .. T-1] in rows 0 ..
    T-1, columns [D, 2D) hold pos[0 .. T-3] in rows T+1 .. 2T-2, and every
    other entry (row T, distance -1, among them) is zero.

    q_v: (B, H, T, D); pos: (H, T, D), row p <-> absolute position p."""
    H, T, D = pos.shape
    q_next = F.pad(q_v[:, :, 1:], (0, 0, 0, 1))
    n_hi = max(0, T - 2)
    lo = F.pad(pos, (0, 0, 0, T - 1))
    hi = F.pad(pos[:, :n_hi], (0, 0, 2 * T - 1 - n_hi, 0))
    return torch.cat([q_v, q_next], dim=-1), torch.cat([lo, hi], dim=-1)


def legacy_dpos(dtable):
    """The adjoint of ``legacy_rel_inputs``' table assembly: the (H, 2T-1,
    2D) gradient of the doubled table mapped back to the (H, T, D) legacy
    table, in dtable's dtype (float32 arithmetic: pos[p] gets rows p of the
    first half and, for p < T-2, row T+1+p of the second). For the tests'
    doubled-width derivation, as ``legacy_rel_inputs``."""
    H, n, D2 = dtable.shape
    T, D = (n + 1) // 2, D2 // 2
    n_hi = max(0, T - 2)
    dpos = dtable[:, :T, :D].float()
    hi = dtable[:, n - n_hi:, D:].float()
    return (dpos + F.pad(hi, (0, 0, 0, T - n_hi))).to(dtable.dtype)


def rel_flash_attention(
    q_u, q_v, k, v, pos, kv_lens: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0, dropout_seed: Optional[int] = None, legacy: bool = False,
) -> torch.Tensor:
    """Flash attention with Transformer-XL relative position scores,
    differentiable, with optional in-kernel dropout.

    Args:
        q_u, q_v: (B, H, T, D) queries with pos_bias_u / pos_bias_v added.
        k, v: (B, H, T, D).
        pos: new style (H, 2T-1, D), row p <-> relative distance T-1-p;
            legacy (H, T, D), row p <-> absolute position p.
        kv_lens: (B,) valid key lengths (None: all T keys).
        dropout_rate: attention-weight dropout probability.
        dropout_seed: a host int in [0, 2^31); required when dropout_rate > 0.
            The forward and the backward draw the same mask from it.
        legacy: the legacy relative-position form (the reference's
            ``LegacyRelPositionMultiHeadedAttention``, ``legacy_band``),
            every kernel on q_v and the table as given.
    Returns:
        (B, H, T, D) context in the input dtype. Rows of a batch item whose
        kv_len is 0 are zeros.
    """
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must lie in [0, 1), got {dropout_rate}")
    B, H, T, D = q_u.shape
    _check_inputs(
        "rel_flash_attention", (q_u, q_v, k, v, pos),
        ((B, H, T, D),) * 4 + ((H, T if legacy else 2 * T - 1, D),),
    )
    _check_device("rel_flash_attention", q_u)
    lens = _kv_lens(kv_lens, B, T, q_u.device).contiguous()
    rate, seed = float(dropout_rate), (None if dropout_seed is None else int(dropout_seed))
    legacy = bool(legacy)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q_u, q_v, k, v, pos)):
        return _RelFlashAttention.apply(q_u, q_v, k, v, pos, lens, rate, seed, legacy)
    return _fwd(q_u, q_v, k, v, pos, lens, rate, seed, need_lse=False, legacy=legacy)[0]


# kernel launches (CPU calls do not count), one counter for each kernel and
# form: ``launches`` new style, ``legacy_launches`` the legacy form
for _wrapper in (rel_flash_attention, rel_flash_bwd_dq, rel_flash_bwd_dkv, rel_flash_bwd_dpos):
    _wrapper.launches = _wrapper.legacy_launches = 0


# ------------------------------------------------ standard flash attention
def flash_attention_plain(q, k, v, kv_lens=None, causal: bool = False,
                          dropout_rate: float = 0.0, dropout_seed=None,
                          return_lse: bool = False):
    """Plain PyTorch version of the standard forward kernel (float32
    arithmetic): q (B, H, Tq, D), k and v (B, H, Tk, D).

    Returns the (B, H, Tq, D) context in q's dtype and, with ``return_lse``,
    the (B, H, Tq) float32 logsumexp of each row's live scores (``-1e30``
    for a row with no live key, whose context is zeros)."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    valid = _valid(_kv_lens(kv_lens, B, Tk, q.device), Tk, q.device, Tq, causal)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(D))
    return _attend(s, valid, v, dropout_rate, dropout_seed, q.dtype, return_lse)


def _std_recompute(q, k, v, kv_lens, lse, delta, d_out, causal, rate, seed):
    """The standard backward's (pd, ds times the 1/sqrt(D) scale), as the
    JAX package's ``_std_block_grads``."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    valid = _valid(_kv_lens(kv_lens, B, Tk, q.device), Tk, q.device, Tq, causal)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    pd, ds = _tile_grads(s, valid, v, lse, delta, d_out, rate, seed)
    return pd, ds * scale


def flash_bwd_dq_plain(q, k, v, kv_lens, lse, delta, d_out, causal=False,
                       dropout_rate=0.0, dropout_seed=None):
    """Plain version of the dq kernel: dq in q's dtype."""
    _, ds = _std_recompute(q, k, v, kv_lens, lse, delta, d_out, causal, dropout_rate,
                           dropout_seed)
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, kv_lens, lse, delta, d_out, causal=False,
                        dropout_rate=0.0, dropout_seed=None):
    """Plain version of the dk/dv kernel: (dk, dv) in the dtypes of k, v."""
    pd, ds = _std_recompute(q, k, v, kv_lens, lse, delta, d_out, causal, dropout_rate,
                            dropout_seed)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()).to(k.dtype)
    dv = torch.matmul(pd.transpose(-1, -2), d_out.float()).to(v.dtype)
    return dk, dv


def flash_attention_bwd_plain(q, k, v, kv_lens, out, lse, d_out, causal: bool = False,
                              dropout_rate: float = 0.0, dropout_seed=None):
    """Plain PyTorch version of the whole standard backward (float32
    arithmetic): (dq, dk, dv) in the dtypes of (q, k, v), from the forward's
    output ``out`` and logsumexp ``lse`` and the output's cotangent."""
    pd, ds = _std_recompute(q, k, v, kv_lens, lse, _delta(out, d_out), d_out, causal,
                            dropout_rate, dropout_seed)
    dq = torch.matmul(ds, k.float()).to(q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()).to(k.dtype)
    dv = torch.matmul(pd.transpose(-1, -2), d_out.float()).to(v.dtype)
    return dq, dk, dv


def _check_std(name, q, k, v, extra=()):
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    _check_inputs(name, (q, k, v) + tuple(t for t, _ in extra),
                  ((B, H, Tq, D), (B, H, Tk, D), (B, H, Tk, D)) + tuple(s for _, s in extra))
    _check_device(name, q)
    if q.device.type == "cuda" and D > STD_MAX_D:
        raise ValueError(f"{name}: head dim {D} > {STD_MAX_D} not supported")


def _std_fwd(q, k, v, lens, causal, rate, seed, need_lse):
    """Forward: kernel 9 on a CUDA tensor, the plain version on a CPU one.
    Returns (out, lse or None)."""
    if q.device.type == "cpu":
        if need_lse:
            return flash_attention_plain(q, k, v, lens, causal, rate, seed, True)
        return flash_attention_plain(q, k, v, lens, causal, rate, seed), None
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    out = torch.empty_like(qc)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device) if need_lse else None
    fn = native.load("flash").flash_fwd
    fn.restype = _i
    fn.argtypes = [_i] + [_c] * 6 + [_i] * 5 + [_f, _i, _f, _f, ctypes.c_uint32, _i, _i, _c]
    with torch.cuda.device(q.device):
        rc = fn(DTYPE_CODES[q.dtype], qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                lens.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
                B * H, H, Tq, Tk, D, 1.0 / math.sqrt(D), int(causal),
                *_dropout_args(rate, seed, Tq, Tk), _stream(q))
    native.check(rc, "flash_fwd")
    flash_attention.launches += 1
    return out, lse


def _std_bwd_args(name, q, k, v, kv_lens, lse, delta, d_out):
    B, H, Tq, D = q.shape
    _check_std(name, q, k, v, ((d_out, (B, H, Tq, D)),))
    for t, what in ((lse, "lse"), (delta, "delta")):
        if tuple(t.shape) != (B, H, Tq):
            raise ValueError(f"{name}: {what} must be {(B, H, Tq)}, got {tuple(t.shape)}")
    lens = _kv_lens(kv_lens, B, k.shape[2], q.device).contiguous()
    return [t.contiguous() for t in (q, k, v)] + [lens, lse.float().contiguous(),
                                                   delta.float().contiguous(), d_out.contiguous()]


def _std_bwd_launch(symbol, ins, outs, causal, rate, seed):
    q, k = ins[0], ins[1]
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    fn = getattr(native.load("flash_bwd"), symbol)
    fn.restype = _i
    fn.argtypes = ([_i] + [_c] * (len(ins) + len(outs)) + [_i] * 5
                   + [_f, _i, _f, _f, ctypes.c_uint32, _i, _i, _c])
    with torch.cuda.device(q.device):
        rc = fn(DTYPE_CODES[q.dtype], *(t.data_ptr() for t in ins + list(outs)),
                B * H, H, Tq, Tk, D, 1.0 / math.sqrt(D), int(causal),
                *_dropout_args(rate, seed, Tq, Tk), _stream(q))
    native.check(rc, symbol)


def flash_bwd_dq(q, k, v, kv_lens, lse, delta, d_out, causal: bool = False,
                 dropout_rate: float = 0.0, dropout_seed=None):
    """dq: on a CUDA tensor kernel 10 of ``csrc/flash_bwd.cu`` (one launch),
    on a CPU tensor ``flash_bwd_dq_plain``. ``lse`` and ``delta =
    rowsum(dO * O)`` are (B, H, Tq) float32."""
    ins = _std_bwd_args("flash_bwd_dq", q, k, v, kv_lens, lse, delta, d_out)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(*ins, causal, dropout_rate, dropout_seed)
    dq = torch.empty_like(ins[0])
    _std_bwd_launch("flash_bwd_dq", ins, (dq,), causal, dropout_rate, dropout_seed)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, kv_lens, lse, delta, d_out, causal: bool = False,
                  dropout_rate: float = 0.0, dropout_seed=None):
    """(dk, dv): on a CUDA tensor kernel 11 of ``csrc/flash_bwd.cu`` (one
    launch), on a CPU tensor ``flash_bwd_dkv_plain``."""
    ins = _std_bwd_args("flash_bwd_dkv", q, k, v, kv_lens, lse, delta, d_out)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(*ins, causal, dropout_rate, dropout_seed)
    dk, dv = torch.empty_like(ins[1]), torch.empty_like(ins[2])
    _std_bwd_launch("flash_bwd_dkv", ins, (dk, dv), causal, dropout_rate, dropout_seed)
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, kv_lens, out, lse, d_out, causal: bool = False,
                        dropout_rate: float = 0.0, dropout_seed=None):
    """(dq, dk, dv): on a CUDA tensor kernels 10 and 11, on a CPU tensor
    ``flash_attention_bwd_plain``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, kv_lens, out, lse, d_out, causal,
                                         dropout_rate, dropout_seed)
    args = (q, k, v, kv_lens, lse, _delta(out, d_out), d_out, causal, dropout_rate,
            dropout_seed)
    return (flash_bwd_dq(*args), *flash_bwd_dkv(*args))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lens, causal, rate, seed):
        out, lse = _std_fwd(q, k, v, lens, causal, rate, seed, need_lse=True)
        ctx.save_for_backward(q, k, v, lens, out, lse)
        ctx.causal, ctx.rate, ctx.seed = causal, rate, seed
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, lens, out, lse = ctx.saved_tensors
        grads = flash_attention_bwd(q, k, v, lens, out, lse, d_out, ctx.causal, ctx.rate,
                                    ctx.seed)
        return (*grads, None, None, None, None)


def flash_attention(
    q, k, v, kv_lens: Optional[torch.Tensor] = None, causal: bool = False,
    dropout_rate: float = 0.0, dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """Standard multi-head flash attention, differentiable, with optional
    in-kernel dropout (the JAX package's ``flash_attention``).

    Args:
        q: (B, H, Tq, D) queries; k, v: (B, H, Tk, D) keys and values.
        kv_lens: (B,) valid key lengths (None: all Tk keys).
        causal: key j is live for query i only where j <= i.
        dropout_rate: attention-weight dropout probability.
        dropout_seed: a host int in [0, 2^31); required when dropout_rate > 0.
            The forward and the backward draw the same mask from it.
    Returns:
        (B, H, Tq, D) context in q's dtype. Rows with no live key are zeros.
    """
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must lie in [0, 1), got {dropout_rate}")
    _check_std("flash_attention", q, k, v)
    lens = _kv_lens(kv_lens, q.shape[0], k.shape[2], q.device).contiguous()
    causal, rate = bool(causal), float(dropout_rate)
    seed = None if dropout_seed is None else int(dropout_seed)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, lens, causal, rate, seed)
    return _std_fwd(q, k, v, lens, causal, rate, seed, need_lse=False)[0]


flash_attention.launches = 0  # kernel 9 launches (CPU calls do not count)
flash_bwd_dq.launches = 0  # kernel 10
flash_bwd_dkv.launches = 0  # kernel 11
