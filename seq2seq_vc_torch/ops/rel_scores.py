"""Fused relative-position attention scores (new-style rel-pos), forward.

``fused_rel_scores`` computes ``(q_u k^T + rel_shift(q_v pos^T)) / sqrt(D)``
without materialising the (B, H, T, 2T-1) band: on a CUDA tensor it
launches the Hopper kernel in ``csrc/rel_scores.cu``, on a CPU tensor it
runs ``fused_rel_scores_plain``, the same function in plain PyTorch. The
softmax and the product with V that follow stay dense ops in the caller.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import native

# storage-type codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

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
    """Plain PyTorch version of the kernel (float32 arithmetic)."""
    D = q_u.shape[-1]
    ac = torch.einsum("bhqd,bhkd->bhqk", q_u.float(), k.float())
    return (ac + rel_band(q_v, pos)) / math.sqrt(D)


def fused_rel_scores(q_u, q_v, k, pos) -> torch.Tensor:
    """Scaled new-style rel-pos attention scores.

    Args:
        q_u, q_v: (B, H, T, D) queries with pos_bias_u / pos_bias_v added.
        k: (B, H, T, D) keys.
        pos: (H, 2T-1, D) head-split projected rel-pos table
            (RelPositionalEncoding row order: row p <-> distance T-1-p).
    Returns:
        (B, H, T, T) float32 scores, already scaled by 1/sqrt(D). Callers
        apply their padding mask before the softmax.
    """
    B, H, T, D = q_u.shape
    _check_inputs(
        "fused_rel_scores", (q_u, q_v, k, pos),
        ((B, H, T, D),) * 3 + ((H, 2 * T - 1, D),),
    )
    if q_u.device.type == "cpu":
        return fused_rel_scores_plain(q_u, q_v, k, pos)
    if q_u.device.type != "cuda":
        raise ValueError(f"fused_rel_scores: unsupported device {q_u.device}")
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


fused_rel_scores.launches = 0  # kernel launches (CPU calls do not count)
