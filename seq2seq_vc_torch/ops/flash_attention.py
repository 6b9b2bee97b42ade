"""Relative-position flash attention (new-style rel-pos), forward.

``rel_flash_attention`` computes ``softmax((q_u k^T + rel_shift(q_v pos^T))
/ sqrt(D)) v`` with a key-length mask, online, without materialising the
(T, T) scores: on a CUDA tensor it launches the Hopper kernel in
``csrc/rel_flash.cu``, on a CPU tensor it runs ``rel_flash_attention_plain``,
the same function in plain PyTorch. Inference only: no dropout, no
backward. Under autograd with an input that requires grad it raises
``NotImplementedError`` on every device rather than return a tensor with no
gradient: the flash backward kernels come with the long-utterance training
slice.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import native
from .rel_scores import DTYPE_CODES, _check_inputs, fused_rel_scores_plain

NEG_INF = -1e30  # finite mask value, as in the JAX kernels

_c = ctypes.c_void_p


def _kv_lens(kv_lens, B, T, device):
    if kv_lens is None:
        return torch.full((B,), T, dtype=torch.int32, device=device)
    if tuple(kv_lens.shape) != (B,):
        raise ValueError(f"kv_lens: expected shape ({B},), got {tuple(kv_lens.shape)}")
    return kv_lens.to(device=device, dtype=torch.int32)


def rel_flash_attention_plain(q_u, q_v, k, v, pos, kv_lens=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (float32 arithmetic)."""
    B, H, T, _ = q_u.shape
    lens = _kv_lens(kv_lens, B, T, q_u.device)
    s = fused_rel_scores_plain(q_u, q_v, k, pos)
    valid = (torch.arange(T, device=q_u.device)[None, :] < lens[:, None])[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / torch.where(l == 0, 1.0, l)
    return out.to(q_u.dtype)


def rel_flash_attention(
    q_u, q_v, k, v, pos, kv_lens: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Flash attention with Transformer-XL relative position scores.

    Args:
        q_u, q_v: (B, H, T, D) queries with pos_bias_u / pos_bias_v added.
        k, v: (B, H, T, D).
        pos: (H, 2T-1, D), row p <-> relative distance T-1-p.
        kv_lens: (B,) valid key lengths (None: all T keys).
    Returns:
        (B, H, T, D) context in the input dtype. Rows of a batch item whose
        kv_len is 0 are zeros.
    """
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (q_u, q_v, k, v, pos)
    ):
        raise NotImplementedError(
            "rel_flash_attention has no backward yet: the rel-pos flash backward "
            "kernels (dq, dk/dv, dpos), with in-kernel dropout and the saved "
            "logsumexp, come with the next port slice (long-utterance training). "
            "Train below the flash gate (the fused path) or call under torch.no_grad()."
        )
    B, H, T, D = q_u.shape
    _check_inputs(
        "rel_flash_attention", (q_u, q_v, k, v, pos),
        ((B, H, T, D),) * 4 + ((H, 2 * T - 1, D),),
    )
    if q_u.device.type == "cpu":
        return rel_flash_attention_plain(q_u, q_v, k, v, pos, kv_lens)
    if q_u.device.type != "cuda":
        raise ValueError(f"rel_flash_attention: unsupported device {q_u.device}")
    if D > 1024:
        raise ValueError(f"rel_flash_attention: head dim {D} > 1024 not supported")
    lens = _kv_lens(kv_lens, B, T, q_u.device).contiguous()
    qu, qv, kc, vc, pc = (t.contiguous() for t in (q_u, q_v, k, v, pos))
    out = torch.empty((B, H, T, D), dtype=q_u.dtype, device=q_u.device)
    lib = native.load("rel_flash")
    fn = lib.rel_flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, _c, _c, _c, _c, _c, _c, _c, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _c]
    with torch.cuda.device(q_u.device):
        rc = fn(
            DTYPE_CODES[q_u.dtype], qu.data_ptr(), qv.data_ptr(), kc.data_ptr(),
            vc.data_ptr(), pc.data_ptr(), lens.data_ptr(), out.data_ptr(),
            B * H, H, T, D, 1.0 / math.sqrt(D),
            torch.cuda.current_stream(q_u.device).cuda_stream,
        )
    native.check(rc, "rel_flash_fwd")
    rel_flash_attention.launches += 1
    return out


rel_flash_attention.launches = 0  # kernel launches (CPU calls do not count)
