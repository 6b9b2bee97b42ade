"""Shared model-level helpers (mirrors seq2seq_vc_tpu/models/common.py)."""

from __future__ import annotations

import torch


def reduce_frames(xs: torch.Tensor, lens: torch.Tensor, factor: int):
    """(B, T, D) -> (B, T//factor, D*factor) frame stacking; lens //= factor.

    T must already be a multiple of ``factor`` (the caller pads).
    """
    if factor <= 1:
        return xs, lens
    B, T, D = xs.shape
    if T % factor:
        raise ValueError(f"pad time dim {T} to a multiple of {factor}")
    return xs.reshape(B, T // factor, D * factor), lens // factor


def conv2d_subsampled_lengths(lens: torch.Tensor) -> torch.Tensor:
    """Length after two VALID stride-2 3x3 convs."""
    return ((lens - 2 + 1) // 2 - 2 + 1) // 2


def nearest_interpolate(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Nearest-neighbour resize along time: (B, T, C) -> (B, out_len, C),
    index floor(out_idx * T_in / T_out) as torch ``F.interpolate``."""
    t_in = x.shape[1]
    idx = torch.arange(out_len, device=x.device) * t_in // out_len
    return x[:, idx, :]


def speaker_projection(spk_embed_dim, integration_type: str, adim: int, device=None):
    """The speaker-embedding projection of the four models (their
    ``projection``): ``Linear(spk_embed_dim, adim)`` for ``add``,
    ``Linear(adim + spk_embed_dim, adim)`` for ``concat``; None without
    speaker embeddings."""
    from ..nn.layers import Linear

    if spk_embed_dim is None:
        return None
    if integration_type not in ("add", "concat"):
        raise ValueError(f"unknown spk_embed_integration_type: {integration_type}")
    idim = spk_embed_dim if integration_type == "add" else adim + spk_embed_dim
    return Linear(idim, adim, device=device)


def integrate_spk_embed(projection, integration_type: str, hs: torch.Tensor,
                        spembs: torch.Tensor) -> torch.Tensor:
    """hs (B, T, adim) with the (B, spk_embed_dim) speaker embeddings,
    L2-normalised (the norm floored at 1e-12): projected and added to every
    frame (``add``), or tiled, concatenated to every frame and projected
    (``concat``); the JAX models' ``_integrate_with_spk_embed``."""
    if spembs is None:
        raise ValueError("the model has speaker embeddings (spk_embed_dim): pass spembs")
    spembs = spembs / torch.clamp(torch.linalg.vector_norm(spembs, dim=-1, keepdim=True),
                                  min=1e-12)
    if integration_type == "add":
        return hs + projection(spembs)[:, None, :]
    tiled = spembs[:, None, :].expand(*hs.shape[:2], spembs.shape[-1])
    return projection(torch.cat([hs, tiled.to(hs.dtype)], dim=-1))
