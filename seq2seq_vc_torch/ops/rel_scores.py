"""Fused relative-position attention scores (new-style rel-pos), forward and
backward.

``fused_rel_scores`` computes ``(q_u k^T + rel_shift(q_v pos^T)) / sqrt(D)``
without materialising the (B, H, T, 2T-1) band, as a
``torch.autograd.Function``. Forward: on a CUDA tensor the Hopper kernel in
``csrc/rel_scores.cu``, on a CPU tensor ``fused_rel_scores_plain``. The
softmax and the product with V that follow stay dense ops in the caller.

Backward (``core_bwd`` of seq2seq_vc_tpu/ops/rel_scores.py): ``dq_u`` and
``dk`` are plain matmuls on the score cotangent ``g``; ``dq_v`` and the
table gradient ``dpos`` come from one of the JAX package's variants,
chosen by ``bwd``:

- ``"xla"``: rebuild the (T, 2T-1) band cotangent once with the inverse of
  the Transformer-XL pad/reshape shift, then two dense contractions;
- ``"banded"``: ``rel_band_bwd``, on a CUDA tensor the Hopper kernel in
  ``csrc/rel_scores_bwd.cu`` (the band cotangent never reaches device
  memory), on a CPU tensor ``rel_band_bwd_plain``;
- ``"pallas"``: the diagonal-reduction pair, two launches: ``dq_v`` from
  ``rel_band_bwd_dqv`` (a block owns query rows and walks the table rows
  they touch) and ``dpos`` from ``rel_band_bwd_dpos`` (a block owns table
  rows and walks the band diagonals), kernel 3's two halves, the Hopper
  kernels in ``csrc/rel_scores_bwd_pair.cu`` on a CUDA tensor, their plain
  versions on a CPU one. The name is the JAX package's (``S2S_REL_SCORES_BWD=pallas``
  there), so a run that names it carries over; ``"auto"`` never picks it;
- ``"auto"``: ``"banded"`` from ``AUTO_BANDED_MIN_LEN`` key frames up
  (one: every length), ``"xla"`` below.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import native

# storage-type codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# bwd="auto" gate: from this many key frames up the banded kernel takes the
# backward. ``python3 chip_smoke.py --bwd-sweep`` timed the variants on an
# H100 80GB HBM3 at 700 W at the training step's batch (B 16, H 2, bf16)
# for T from 1 to 2048 at D 192 and 768 (each D's first length read twice,
# the first reading dropped), and kernel 3 beat ``xla`` at all 38 points,
# 3.8-10.0x (T 32: 0.039 against 0.262 ms at D 192, 0.026 against 0.166 at
# D 768; PERF.md); below T 128 those times are mostly the host's launch
# path. So the gate sits at one frame: ``auto`` takes the kernel at every
# length. Not the TPU's AUTO_BANDED_MIN_LEN (768).
AUTO_BANDED_MIN_LEN = 1
BWD_VARIANTS = ("auto", "xla", "banded", "pallas")

_c = ctypes.c_void_p


def _check_inputs(name, tensors, shapes):
    dt = tensors[0].dtype
    if dt not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dt} not supported (float32 or bfloat16)")
    for t, shape in zip(tensors, shapes):
        if t.dtype != dt:
            raise TypeError(f"{name}: all inputs must share dtype {dt}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _check_device(name, t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def _band_index(T: int, device):
    """(T, 2T-1) key index j = i + r - (T-1) of band cell (i, r), and
    whether it lies in [0, T)."""
    i = torch.arange(T, device=device)[:, None]
    r = torch.arange(2 * T - 1, device=device)[None, :]
    j = i + r - (T - 1)
    return j.clamp(0, T - 1), (j >= 0) & (j < T)


def rel_band(q_v: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """bd[b, h, i, j] = q_v[b, h, i] . pos[h, T-1-i+j], in float32.

    Plain version of the band skew: the (T, 2T-1) product is gathered along
    its diagonals by index arithmetic (independent of the Transformer-XL
    pad/reshape ``rel_shift`` that the dense attention path uses).
    """
    B, H, T, _ = q_v.shape
    raw = torch.einsum("bhqd,hpd->bhqp", q_v.float(), pos.float())
    i = torch.arange(T, device=q_v.device)
    idx = (T - 1 - i)[:, None] + i[None, :]  # (T, T): row T-1-i+j
    return torch.gather(raw, 3, idx.expand(B, H, T, T))


def fused_rel_scores_plain(q_u, q_v, k, pos) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel (float32 arithmetic)."""
    D = q_u.shape[-1]
    ac = torch.einsum("bhqd,bhkd->bhqk", q_u.float(), k.float())
    return (ac + rel_band(q_v, pos)) / math.sqrt(D)


def _score_side_grads(g, q_u, k, scale):
    """dq_u = g k scale and dk = g^T q_u scale: plain matmuls, as in JAX."""
    dq_u = (torch.matmul(g, k.float()) * scale).to(q_u.dtype)
    dk = (torch.matmul(g.transpose(-1, -2), q_u.float()) * scale).to(k.dtype)
    return dq_u, dk


def _band_cotangent(g, T: int):
    """The (B, H, T, 2T-1) band cotangent G[b, h, i, r] = g[b, h, i, i + r -
    (T-1)] (zero where that key index leaves [0, T)) in float32, gathered by
    index arithmetic along the diagonals, as ``rel_band`` gathers the
    forward band."""
    B, H = g.shape[:2]
    idx, valid = _band_index(T, g.device)
    return torch.gather(g.float(), 3, idx.expand(B, H, T, 2 * T - 1)) * valid


def _scale(q_v, scale):
    return 1.0 / math.sqrt(q_v.shape[-1]) if scale is None else scale


def rel_band_bwd_dqv_plain(g, q_v, pos, scale=None):
    """Plain PyTorch version of the dq_v kernel (float32 arithmetic):
    ``dq_v = scale * G . pos`` in q_v's dtype, from the (B, H, T, T) score
    cotangent ``g``. ``scale`` defaults to 1/sqrt(q_v's width); a caller
    whose q_v is wider than its head dim (legacy rel-pos) passes its own."""
    band = _band_cotangent(g, q_v.shape[2])
    dq_v = torch.einsum("bhir,hrd->bhid", band, pos.float()) * _scale(q_v, scale)
    return dq_v.to(q_v.dtype)


def rel_band_bwd_dpos_plain(g, q_v, pos, scale=None):
    """Plain PyTorch version of the table-gradient kernel (float32
    arithmetic): ``dpos = scale * sum_b G^T . q_v`` in pos's dtype, summed
    over the batch in float32 before the cast."""
    band = _band_cotangent(g, q_v.shape[2])
    dpos = torch.einsum("bhir,bhid->hrd", band, q_v.float()) * _scale(q_v, scale)
    return dpos.to(pos.dtype)


def rel_band_bwd_plain(g, q_v, pos, scale=None):
    """Plain PyTorch version of the backward kernel: (dq_v, dpos) from the
    (B, H, T, T) score cotangent ``g``, the two plain versions above."""
    return (rel_band_bwd_dqv_plain(g, q_v, pos, scale),
            rel_band_bwd_dpos_plain(g, q_v, pos, scale))


def _rel_unshift(g: torch.Tensor) -> torch.Tensor:
    """Transpose of the new-style ``rel_shift``: (.., T, T) -> (.., T, 2T-1)
    by the same pad/reshape/slice moves, in reverse
    (``_rel_unshift_xla`` of the JAX package)."""
    *lead, t, _ = g.shape
    n = 2 * t - 1
    g2 = torch.nn.functional.pad(g, (0, n - t)).reshape(*lead, n, t)
    g2 = torch.nn.functional.pad(g2, (0, 0, 1, 0)).reshape(*lead, t, n + 1)
    return g2[..., 1:]


def rel_band_bwd_xla(g, q_v, pos):
    """The ``"xla"`` variant's (dq_v, dpos): the band cotangent rebuilt once
    in dense ops, then two contractions with the table and with q_v."""
    band = _rel_unshift(g.float() / math.sqrt(q_v.shape[-1]))  # (B, H, T, 2T-1)
    dq_v = torch.einsum("bhqn,hnd->bhqd", band, pos.float()).to(q_v.dtype)
    dpos = torch.einsum("bhqn,bhqd->hnd", band, q_v.float()).to(pos.dtype)
    return dq_v, dpos


def _band_bwd_args(name, g, q_v, pos):
    """Raise on inputs the backward wrappers do not take."""
    B, H, T, D = q_v.shape
    _check_inputs(name, (q_v, pos), ((B, H, T, D), (H, 2 * T - 1, D)))
    if tuple(g.shape) != (B, H, T, T):
        raise ValueError(f"{name}: g must be {(B, H, T, T)}, got {tuple(g.shape)}")
    _check_device(name, q_v)


def _band_bwd_launch(library, symbol, g, q_v, pos, outs):
    """One launch of a backward kernel of ``library`` taking (g, q_v, pos,
    *outs, B, H, T, D, scale, stream)."""
    B, H, T, D = q_v.shape
    gc, qv, pc = g.float().contiguous(), q_v.contiguous(), pos.contiguous()
    fn = getattr(native.load(library), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [_c] * (3 + len(outs))
                   + [ctypes.c_int] * 4 + [ctypes.c_float, _c])
    with torch.cuda.device(q_v.device):
        rc = fn(
            DTYPE_CODES[q_v.dtype], gc.data_ptr(), qv.data_ptr(), pc.data_ptr(),
            *(t.data_ptr() for t in outs), B, H, T, D, 1.0 / math.sqrt(D),
            torch.cuda.current_stream(q_v.device).cuda_stream,
        )
    native.check(rc, symbol)


def rel_band_bwd(g, q_v, pos):
    """(dq_v, dpos) of the scores from their cotangent ``g``: on a CUDA
    tensor the Hopper kernel in ``csrc/rel_scores_bwd.cu`` (one launch), on
    a CPU tensor ``rel_band_bwd_plain``. q_v (B, H, T, D) and pos
    (H, 2T-1, D) as ``fused_rel_scores`` takes them; ``g`` (B, H, T, T) is
    read as float32."""
    _band_bwd_args("rel_band_bwd", g, q_v, pos)
    if q_v.device.type == "cpu":
        return rel_band_bwd_plain(g, q_v, pos)
    dq_v = torch.empty_like(q_v, memory_format=torch.contiguous_format)
    dpos = torch.empty_like(pos, memory_format=torch.contiguous_format)
    _band_bwd_launch("rel_scores_bwd", "rel_scores_bwd", g, q_v, pos, (dq_v, dpos))
    rel_band_bwd.launches += 1
    return dq_v, dpos


def rel_band_bwd_dqv(g, q_v, pos):
    """dq_v of the scores from their cotangent ``g``: on a CUDA tensor
    kernel 4 of ``csrc/rel_scores_bwd_pair.cu`` (one launch), on a CPU
    tensor ``rel_band_bwd_dqv_plain``. Inputs as ``rel_band_bwd``."""
    _band_bwd_args("rel_band_bwd_dqv", g, q_v, pos)
    if q_v.device.type == "cpu":
        return rel_band_bwd_dqv_plain(g, q_v, pos)
    dq_v = torch.empty_like(q_v, memory_format=torch.contiguous_format)
    _band_bwd_launch("rel_scores_bwd_pair", "rel_scores_bwd_dqv", g, q_v, pos, (dq_v,))
    rel_band_bwd_dqv.launches += 1
    return dq_v


def rel_band_bwd_dpos(g, q_v, pos):
    """The table gradient dpos (H, 2T-1, D) from the score cotangent ``g``:
    on a CUDA tensor kernel 5 of ``csrc/rel_scores_bwd_pair.cu`` (one
    launch, deterministic), on a CPU tensor ``rel_band_bwd_dpos_plain``."""
    _band_bwd_args("rel_band_bwd_dpos", g, q_v, pos)
    if q_v.device.type == "cpu":
        return rel_band_bwd_dpos_plain(g, q_v, pos)
    dpos = torch.empty_like(pos, memory_format=torch.contiguous_format)
    _band_bwd_launch("rel_scores_bwd_pair", "rel_scores_bwd_dpos", g, q_v, pos, (dpos,))
    rel_band_bwd_dpos.launches += 1
    return dpos


def fused_rel_scores_bwd_plain(g, q_u, q_v, k, pos):
    """Plain PyTorch version of the whole backward: (dq_u, dq_v, dk, dpos)
    in the dtypes of (q_u, q_v, k, pos)."""
    dq_u, dk = _score_side_grads(g.float(), q_u, k, 1.0 / math.sqrt(q_u.shape[-1]))
    dq_v, dpos = rel_band_bwd_plain(g, q_v, pos)
    return dq_u, dq_v, dk, dpos


def resolve_bwd(bwd: str, t: int) -> str:
    """``"auto"`` -> ``"banded"`` from ``AUTO_BANDED_MIN_LEN`` keys up, else
    ``"xla"`` (never ``"pallas"``); the other variants stand as they are."""
    if bwd not in BWD_VARIANTS:
        raise ValueError(f"fused_rel_scores: unknown bwd {bwd!r} (one of {BWD_VARIANTS})")
    if bwd == "auto":
        return "banded" if t >= AUTO_BANDED_MIN_LEN else "xla"
    return bwd


def _fwd(q_u, q_v, k, pos) -> torch.Tensor:
    """Forward: kernel 1 on a CUDA tensor, the plain version on a CPU one."""
    B, H, T, D = q_u.shape
    if q_u.device.type == "cpu":
        return fused_rel_scores_plain(q_u, q_v, k, pos)
    qu, qv, kc, pc = (t.contiguous() for t in (q_u, q_v, k, pos))
    out = torch.empty((B, H, T, T), dtype=torch.float32, device=q_u.device)
    lib = native.load("rel_scores")
    fn = lib.rel_scores_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, _c, _c, _c, _c, _c, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, _c]
    with torch.cuda.device(q_u.device):
        rc = fn(
            DTYPE_CODES[q_u.dtype], qu.data_ptr(), qv.data_ptr(), kc.data_ptr(),
            pc.data_ptr(), out.data_ptr(), B * H, H, T, D, 1.0 / math.sqrt(D),
            torch.cuda.current_stream(q_u.device).cuda_stream,
        )
    native.check(rc, "rel_scores_fwd")
    fused_rel_scores.launches += 1
    return out


def fused_rel_scores_bwd(g, q_u, q_v, k, pos, bwd: str = "banded"):
    """(dq_u, dq_v, dk, dpos) from the score cotangent ``g``: dq_u and dk by
    matmuls, dq_v and dpos by the ``bwd`` variant (``"banded"``: kernel 3 on
    a CUDA tensor, ``"pallas"``: kernels 4 and 5, ``"xla"``: the dense band
    rebuild)."""
    if bwd == "pallas":
        dq_v, dpos = rel_band_bwd_dqv(g, q_v, pos), rel_band_bwd_dpos(g, q_v, pos)
    else:
        dq_v, dpos = (rel_band_bwd_xla if bwd == "xla" else rel_band_bwd)(g, q_v, pos)
    dq_u, dk = _score_side_grads(g.float(), q_u, k, 1.0 / math.sqrt(q_u.shape[-1]))
    return dq_u, dq_v, dk, dpos


class _FusedRelScores(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_u, q_v, k, pos, bwd):
        ctx.save_for_backward(q_u, q_v, k, pos)
        ctx.bwd = bwd
        return _fwd(q_u, q_v, k, pos)

    @staticmethod
    def backward(ctx, g):
        return (*fused_rel_scores_bwd(g, *ctx.saved_tensors, bwd=ctx.bwd), None)


def fused_rel_scores(q_u, q_v, k, pos, bwd: str = "auto") -> torch.Tensor:
    """Scaled new-style rel-pos attention scores, differentiable.

    Args:
        q_u, q_v: (B, H, T, D) queries with pos_bias_u / pos_bias_v added.
        k: (B, H, T, D) keys.
        pos: (H, 2T-1, D) head-split projected rel-pos table
            (RelPositionalEncoding row order: row p <-> distance T-1-p).
        bwd: backward variant, ``"auto"``, ``"xla"``, ``"banded"`` or
            ``"pallas"`` (see the module docstring); resolved here from T.
    Returns:
        (B, H, T, T) float32 scores, already scaled by 1/sqrt(D). Callers
        apply their padding mask before the softmax.
    """
    B, H, T, D = q_u.shape
    _check_inputs(
        "fused_rel_scores", (q_u, q_v, k, pos),
        ((B, H, T, D),) * 3 + ((H, 2 * T - 1, D),),
    )
    _check_device("fused_rel_scores", q_u)
    return _FusedRelScores.apply(q_u, q_v, k, pos, resolve_bwd(bwd, T))


fused_rel_scores.launches = 0  # forward kernel launches (CPU calls do not count)
rel_band_bwd.launches = 0  # backward kernel launches (CPU calls do not count)
rel_band_bwd_dqv.launches = 0  # kernel 4
rel_band_bwd_dpos.launches = 0  # kernel 5
