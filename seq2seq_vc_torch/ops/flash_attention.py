"""Relative-position flash attention (new-style rel-pos), forward and backward.

``rel_flash_attention`` computes ``dropout(softmax((q_u k^T +
rel_shift(q_v pos^T)) / sqrt(D))) v`` with a key-length mask, online,
without materialising the (T, T) scores, as a ``torch.autograd.Function``:

- forward: on a CUDA tensor the Hopper kernel in ``csrc/rel_flash.cu``
  (with in-kernel dropout and, under autograd, the saved logsumexp), on a
  CPU tensor ``rel_flash_attention_plain``;
- backward (FlashAttention-2 style: the score tiles are recomputed from
  q, k, the table and the saved logsumexp): on a CUDA tensor the three
  kernels of ``csrc/rel_flash_bwd.cu`` (``rel_flash_bwd_dq``,
  ``rel_flash_bwd_dkv``, ``rel_flash_bwd_dpos``), on a CPU tensor
  ``rel_flash_attention_bwd_plain``.

Dropout acts on the *normalised* weights with 1/(1-rate) scaling (the
softmax's row sum is taken before the drop), torch-style. Its keep mask is
a counter-based hash (murmur3 finaliser) of the score element's index
``(bh * t_pad + i) * t_pad + j`` with ``t_pad = round_up(T, 128)``: the
same bits as the JAX package's kernels (seq2seq_vc_tpu/ops/flash_attention.py
``_mix_bits``, ``_keep_from_bits``), which run with the default block of
128. The forward and every backward kernel draw the same mask; the port's
own tile sizes never enter the index.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import native
from .rel_scores import (
    DTYPE_CODES,
    _check_device,
    _check_inputs,
    _score_side_grads,
    fused_rel_scores_plain,
    rel_band_bwd_plain,
)

NEG_INF = -1e30  # finite mask value, as in the JAX kernels
# the JAX entry's default block: the dropout index runs over rows and keys
# padded to a multiple of it
DROPOUT_BLOCK = 128
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
    """p (B, H, T, T) -> the kept weights scaled by 1/(1-rate) in float32."""
    if rate <= 0.0:
        return p
    B, H, T, _ = p.shape
    t_pad = _round_up(T, DROPOUT_BLOCK)
    keep = _keep_mask(seed, B * H, T, T, t_pad, t_pad, rate, p.device).view(B, H, T, T)
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


def _valid(lens, T, device):
    """(B, 1, 1, T) whether key j lies below its batch row's length."""
    return (torch.arange(T, device=device)[None, :] < lens[:, None])[:, None, None, :]


def rel_flash_attention_plain(q_u, q_v, k, v, pos, kv_lens=None, dropout_rate: float = 0.0,
                              dropout_seed=None, return_lse: bool = False):
    """Plain PyTorch version of the forward kernel (float32 arithmetic).

    Returns the (B, H, T, D) context in the input dtype and, with
    ``return_lse``, the (B, H, T) float32 logsumexp of each row's scores
    (``-1e30`` for a row with no live key, whose context is zeros)."""
    B, H, T, _ = q_u.shape
    lens = _kv_lens(kv_lens, B, T, q_u.device)
    valid = _valid(lens, T, q_u.device)
    s = torch.where(valid, fused_rel_scores_plain(q_u, q_v, k, pos), NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    p_av = _dropout(p, dropout_rate, dropout_seed)
    out = torch.einsum("bhqk,bhkd->bhqd", p_av, v.float()) / torch.where(l == 0, 1.0, l)
    out = out.to(q_u.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-37)), NEG_INF)
    return out, lse[..., 0]


def _recompute(q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out, rate, seed):
    """The backward's recomputed tiles, whole: (kept weights pd, score
    cotangent ds before the 1/sqrt(D) scale), both (B, H, T, T) float32,
    as the JAX package's ``_rel_block_grads``."""
    B, H, T, _ = q_u.shape
    valid = _valid(_kv_lens(kv_lens, B, T, q_u.device), T, q_u.device)
    s = fused_rel_scores_plain(q_u, q_v, k, pos)
    p = torch.where(valid, torch.exp(s - lse.float()[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", d_out.float(), v.float())
    delta = delta.float()[..., None]
    if rate > 0.0:
        pd = _dropout(p, rate, seed)
        return pd, pd * dp - p * delta
    return p, p * (dp - delta)


def _delta(out, d_out):
    """rowsum(dO * O) in float32: (B, H, T)."""
    return (d_out.float() * out.float()).sum(-1)


def rel_flash_bwd_dq_plain(q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out,
                           dropout_rate=0.0, dropout_seed=None):
    """Plain version of the dq kernel: (dq_u, dq_v) in the dtypes of q_u, q_v."""
    _, ds = _recompute(q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out, dropout_rate,
                       dropout_seed)
    dq_u = (torch.matmul(ds, k.float()) * (1.0 / math.sqrt(q_u.shape[-1]))).to(q_u.dtype)
    dq_v, _ = rel_band_bwd_plain(ds, q_v, pos)
    return dq_u, dq_v


def rel_flash_bwd_dkv_plain(q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out,
                            dropout_rate=0.0, dropout_seed=None):
    """Plain version of the dk/dv kernel: (dk, dv) in the dtypes of k, v."""
    pd, ds = _recompute(q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out, dropout_rate,
                        dropout_seed)
    scale = 1.0 / math.sqrt(q_u.shape[-1])
    dk = (torch.matmul(ds.transpose(-1, -2), q_u.float()) * scale).to(k.dtype)
    dv = torch.matmul(pd.transpose(-1, -2), d_out.float())
    return dk, dv.to(v.dtype)


def rel_flash_bwd_dpos_plain(q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out,
                             dropout_rate=0.0, dropout_seed=None):
    """Plain version of the dpos kernel: the (H, 2T-1, D) table gradient."""
    _, ds = _recompute(q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out, dropout_rate,
                       dropout_seed)
    return rel_band_bwd_plain(ds, q_v, pos)[1]


def rel_flash_attention_bwd_plain(q_u, q_v, k, v, pos, kv_lens, out, lse, d_out,
                                  dropout_rate: float = 0.0, dropout_seed=None):
    """Plain PyTorch version of the whole backward (float32 arithmetic):
    (dq_u, dq_v, dk, dv, dpos) in the dtypes of (q_u, q_v, k, v, pos), from
    the forward's output ``out`` and logsumexp ``lse`` and the output's
    cotangent ``d_out``."""
    pd, ds = _recompute(q_u, q_v, k, v, pos, kv_lens, lse, _delta(out, d_out), d_out,
                        dropout_rate, dropout_seed)
    dq_u, dk = _score_side_grads(ds, q_u, k, 1.0 / math.sqrt(q_u.shape[-1]))
    dv = torch.matmul(pd.transpose(-1, -2), d_out.float()).to(v.dtype)
    dq_v, dpos = rel_band_bwd_plain(ds, q_v, pos)
    return dq_u, dq_v, dk, dv, dpos


# -------------------------------------------------------------- kernels
def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name, D):
    if D > 1024:
        raise ValueError(f"{name}: head dim {D} > 1024 not supported")


def _dropout_args(rate: float, seed, T: int):
    """(rate, 1/(1-rate), seed as uint32, t_pad) as the kernels take them."""
    keep_scale = _keep_scale(rate) if rate > 0.0 else 1.0
    return (_f(rate), _f(keep_scale), ctypes.c_uint32(int(seed or 0) & _M32),
            _round_up(T, DROPOUT_BLOCK))


def _fwd(q_u, q_v, k, v, pos, lens, rate, seed, need_lse):
    """Forward: kernel 2 on a CUDA tensor, the plain version on a CPU one.
    Returns (out, lse or None)."""
    if q_u.device.type == "cpu":
        if need_lse:
            return rel_flash_attention_plain(q_u, q_v, k, v, pos, lens, rate, seed, True)
        return rel_flash_attention_plain(q_u, q_v, k, v, pos, lens, rate, seed), None
    B, H, T, _ = q_u.shape
    out = torch.empty_like(q_u, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q_u.device) if need_lse else None
    _fwd_launch(q_u, q_v, k, v, pos, lens, out, lse, rate, seed)
    rel_flash_attention.launches += 1
    return out, lse


def _fwd_launch(q_u, q_v, k, v, pos, lens, out, lse, rate, seed):
    """One forward kernel launch into ``out`` (and ``lse`` unless None)."""
    B, H, T, D = q_u.shape
    _check_cuda("rel_flash_attention", D)
    qu, qv, kc, vc, pc = (t.contiguous() for t in (q_u, q_v, k, v, pos))
    fn = native.load("rel_flash").rel_flash_fwd
    fn.restype = _i
    fn.argtypes = [_i, _c, _c, _c, _c, _c, _c, _c, _c, _i, _i, _i, _i, _f,
                   _f, _f, ctypes.c_uint32, _i, _c]
    with torch.cuda.device(q_u.device):
        rc = fn(
            DTYPE_CODES[q_u.dtype], qu.data_ptr(), qv.data_ptr(), kc.data_ptr(),
            vc.data_ptr(), pc.data_ptr(), lens.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B * H, H, T, D, 1.0 / math.sqrt(D), *_dropout_args(rate, seed, T), _stream(q_u),
        )
    native.check(rc, "rel_flash_fwd")


def _bwd_launch(symbol, q_u, q_v, k, v, pos, lens, lse, delta, d_out, outs, rate, seed,
                extra=()):
    """One backward kernel launch: the shared argument list of
    ``csrc/rel_flash_bwd.cu``'s C functions, then ``outs`` and ``extra``."""
    B, H, T, D = q_u.shape
    _check_cuda(symbol, D)
    ins = [t.contiguous() for t in (q_u, q_v, k, v, pos, lens, lse, delta, d_out)]
    fn = getattr(native.load("rel_flash_bwd"), symbol)
    fn.restype = _i
    fn.argtypes = ([_i] + [_c] * (len(ins) + len(outs) + len(extra))
                   + [_i, _i, _i, _i, _f, _f, _f, ctypes.c_uint32, _i, _c])
    with torch.cuda.device(q_u.device):
        rc = fn(
            DTYPE_CODES[q_u.dtype], *(t.data_ptr() for t in ins + list(outs) + list(extra)),
            B, H, T, D, 1.0 / math.sqrt(D), *_dropout_args(rate, seed, T), _stream(q_u),
        )
    native.check(rc, symbol)


def _bwd_inputs(name, q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out):
    B, H, T, D = q_u.shape
    _check_inputs(name, (q_u, q_v, k, v, pos, d_out),
                  ((B, H, T, D),) * 4 + ((H, 2 * T - 1, D), (B, H, T, D)))
    for t, what in ((lse, "lse"), (delta, "delta")):
        if tuple(t.shape) != (B, H, T):
            raise ValueError(f"{name}: {what} must be {(B, H, T)}, got {tuple(t.shape)}")
    _check_device(name, q_u)
    return (_kv_lens(kv_lens, B, T, q_u.device).contiguous(), lse.float(), delta.float())


def rel_flash_bwd_dq(q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out,
                     dropout_rate: float = 0.0, dropout_seed=None):
    """(dq_u, dq_v): on a CUDA tensor kernel 6 of ``csrc/rel_flash_bwd.cu``
    (one launch), on a CPU tensor ``rel_flash_bwd_dq_plain``. ``lse`` and
    ``delta = rowsum(dO * O)`` are (B, H, T) float32."""
    lens, lse, delta = _bwd_inputs("rel_flash_bwd_dq", q_u, q_v, k, v, pos, kv_lens, lse,
                                   delta, d_out)
    args = (q_u, q_v, k, v, pos, lens, lse, delta, d_out)
    if q_u.device.type == "cpu":
        return rel_flash_bwd_dq_plain(*args, dropout_rate, dropout_seed)
    dq_u, dq_v = (torch.empty_like(t, memory_format=torch.contiguous_format) for t in (q_u, q_v))
    _bwd_launch("rel_flash_bwd_dq", *args, (dq_u, dq_v), dropout_rate, dropout_seed)
    rel_flash_bwd_dq.launches += 1
    return dq_u, dq_v


def rel_flash_bwd_dkv(q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out,
                      dropout_rate: float = 0.0, dropout_seed=None):
    """(dk, dv): on a CUDA tensor kernel 7 of ``csrc/rel_flash_bwd.cu``, on a
    CPU tensor ``rel_flash_bwd_dkv_plain``."""
    lens, lse, delta = _bwd_inputs("rel_flash_bwd_dkv", q_u, q_v, k, v, pos, kv_lens, lse,
                                   delta, d_out)
    args = (q_u, q_v, k, v, pos, lens, lse, delta, d_out)
    if q_u.device.type == "cpu":
        return rel_flash_bwd_dkv_plain(*args, dropout_rate, dropout_seed)
    dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format) for t in (k, v))
    _bwd_launch("rel_flash_bwd_dkv", *args, (dk, dv), dropout_rate, dropout_seed)
    rel_flash_bwd_dkv.launches += 1
    return dk, dv


def rel_flash_bwd_dpos(q_u, q_v, k, v, pos, kv_lens, lse, delta, d_out,
                       dropout_rate: float = 0.0, dropout_seed=None):
    """The table gradient dpos (H, 2T-1, D): on a CUDA tensor kernel 8 of
    ``csrc/rel_flash_bwd.cu`` (per-batch-group partial sums and a fixed-order
    second pass in the same call: deterministic, no atomics), on a CPU
    tensor ``rel_flash_bwd_dpos_plain``."""
    lens, lse, delta = _bwd_inputs("rel_flash_bwd_dpos", q_u, q_v, k, v, pos, kv_lens, lse,
                                   delta, d_out)
    args = (q_u, q_v, k, v, pos, lens, lse, delta, d_out)
    if q_u.device.type == "cpu":
        return rel_flash_bwd_dpos_plain(*args, dropout_rate, dropout_seed)
    B, H, T, D = q_u.shape
    dpos = torch.empty_like(pos, memory_format=torch.contiguous_format)
    groups = native.load("rel_flash_bwd").rel_flash_bwd_dpos_groups
    groups.restype, groups.argtypes = _i, [_i]
    partial = torch.empty((groups(B), H, 2 * T - 1, D), dtype=torch.float32, device=q_u.device)
    _bwd_launch("rel_flash_bwd_dpos", *args, (dpos,), dropout_rate, dropout_seed,
                extra=(partial,))
    rel_flash_bwd_dpos.launches += 1
    return dpos


def rel_flash_attention_bwd(q_u, q_v, k, v, pos, kv_lens, out, lse, d_out,
                            dropout_rate: float = 0.0, dropout_seed=None):
    """(dq_u, dq_v, dk, dv, dpos): on a CUDA tensor kernels 6, 7 and 8, on a
    CPU tensor ``rel_flash_attention_bwd_plain``."""
    if q_u.device.type == "cpu":
        return rel_flash_attention_bwd_plain(q_u, q_v, k, v, pos, kv_lens, out, lse, d_out,
                                             dropout_rate, dropout_seed)
    args = (q_u, q_v, k, v, pos, kv_lens, lse, _delta(out, d_out), d_out.contiguous(),
            dropout_rate, dropout_seed)
    dq_u, dq_v = rel_flash_bwd_dq(*args)
    dk, dv = rel_flash_bwd_dkv(*args)
    return dq_u, dq_v, dk, dv, rel_flash_bwd_dpos(*args)


class _RelFlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_u, q_v, k, v, pos, lens, rate, seed):
        out, lse = _fwd(q_u, q_v, k, v, pos, lens, rate, seed, need_lse=True)
        ctx.save_for_backward(q_u, q_v, k, v, pos, lens, out, lse)
        ctx.rate, ctx.seed = rate, seed
        return out

    @staticmethod
    def backward(ctx, d_out):
        q_u, q_v, k, v, pos, lens, out, lse = ctx.saved_tensors
        grads = rel_flash_attention_bwd(q_u, q_v, k, v, pos, lens, out, lse, d_out,
                                        ctx.rate, ctx.seed)
        return (*grads, None, None, None)


def rel_flash_attention(
    q_u, q_v, k, v, pos, kv_lens: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0, dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention with Transformer-XL relative position scores,
    differentiable, with optional in-kernel dropout.

    Args:
        q_u, q_v: (B, H, T, D) queries with pos_bias_u / pos_bias_v added.
        k, v: (B, H, T, D).
        pos: (H, 2T-1, D), row p <-> relative distance T-1-p.
        kv_lens: (B,) valid key lengths (None: all T keys).
        dropout_rate: attention-weight dropout probability.
        dropout_seed: a host int in [0, 2^31); required when dropout_rate > 0.
            The forward and the backward draw the same mask from it.
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
        ((B, H, T, D),) * 4 + ((H, 2 * T - 1, D),),
    )
    _check_device("rel_flash_attention", q_u)
    lens = _kv_lens(kv_lens, B, T, q_u.device).contiguous()
    rate, seed = float(dropout_rate), (None if dropout_seed is None else int(dropout_seed))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q_u, q_v, k, v, pos)):
        return _RelFlashAttention.apply(q_u, q_v, k, v, pos, lens, rate, seed)
    return _fwd(q_u, q_v, k, v, pos, lens, rate, seed, need_lse=False)[0]


rel_flash_attention.launches = 0  # forward kernel launches (CPU calls do not count)
rel_flash_bwd_dq.launches = 0  # backward kernel launches, one counter each
rel_flash_bwd_dkv.launches = 0
rel_flash_bwd_dpos.launches = 0
