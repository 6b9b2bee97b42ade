"""Tacotron2-style prenet and postnet (mirror
seq2seq_vc_tpu/nn/pre_postnets.py:23, :42).

The prenet's dropout is always on, at inference too (the reference relies
on it for stable AR decoding), and draws from the ``torch.Generator`` its
caller passes (torch's default generator of the input's device when none).

The postnet's norm is ``MaskedGroupNorm`` (eps 1e-6, ``norm_type:
group_norm``), the JAX package's default in place of the reference
BatchNorm, or with ``norm_type: batch_norm`` the reference's BatchNorm as
flax's ``nn.BatchNorm(use_running_average=deterministic)``
(``nn/conformer.ConvBatchNorm``: running statistics in ``eval()`` mode),
which a reference checkpoint needs. Names follow the reference:
``postnet.N.0`` is the conv (no bias), ``postnet.N.1`` the norm. Each
layer's output goes through dropout (0.5 by default) in ``train()`` mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .conformer import ConvBatchNorm, MaskedGroupNorm
from .layers import Conv1d, Linear


class Prenet(torch.nn.Module):
    """``n_layers`` x (Linear -> ReLU -> always-on dropout). Names follow the
    reference: ``prenet.N.0`` is the Linear."""

    def __init__(self, idim: int, n_layers: int = 2, n_units: int = 256,
                 dropout_rate: float = 0.5, device=None, dtype=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.prenet = torch.nn.ModuleList(
            torch.nn.Sequential(Linear(idim if i == 0 else n_units, n_units, device=device,
                                       dtype=dtype), torch.nn.ReLU())
            for i in range(n_layers)
        )

    def forward(self, x, generator=None):
        """The dropout draws from ``generator`` on the generator's device
        (so one CPU generator gives a model on the card and one on the CPU
        the same mask), or from torch's default generator of x's device."""
        keep_p = 1.0 - self.dropout_rate
        for layer in self.prenet:
            x = layer(x)
            if self.dropout_rate > 0.0:
                u = torch.rand(x.shape, generator=generator,
                               device=x.device if generator is None else generator.device)
                x = torch.where(u.to(x.device) < keep_p, x / keep_p, 0.0)
        return x


class Postnet(torch.nn.Module):
    def __init__(self, odim: int, n_layers: int = 5, n_chans: int = 512,
                 n_filts: int = 5, dropout_rate: float = 0.5, use_norm: bool = True,
                 norm_type: str = "group_norm", compute_dtype=None, device=None, dtype=None):
        super().__init__()
        if norm_type not in ("group_norm", "batch_norm"):
            raise ValueError(f"unknown postnet norm_type: {norm_type}")
        self.compute_dtype = compute_dtype
        self.dropout_rate = dropout_rate
        kw = dict(device=device, dtype=dtype)
        layers = []
        for i in range(n_layers):
            ichans = odim if i == 0 else n_chans
            ochans = odim if i == n_layers - 1 else n_chans
            mods = [Conv1d(ichans, ochans, n_filts, bias=False,
                           compute_dtype=compute_dtype, **kw)]
            if use_norm:
                mods.append(MaskedGroupNorm(ochans, eps=1e-6, **kw) if norm_type == "group_norm"
                            else ConvBatchNorm(ochans, **kw))
            layers.append(torch.nn.ModuleList(mods))
        self.postnet = torch.nn.ModuleList(layers)

    def forward(self, xs, mask=None):
        """xs: (B, T, odim) -> (B, T, odim) residual (not added).

        ``mask`` (B, T) True at valid frames: invalid frames are re-zeroed
        after every layer, so each conv sees zeros past the end, as the
        reference's exact-length decode does, and the group norm's
        statistics ignore them (the batch norm's are the running ones).
        Training passes no mask, as the JAX package's step does: there the
        convs and norms read the padded frames.
        """
        h = xs if self.compute_dtype is None else xs.to(self.compute_dtype)
        n = len(self.postnet)
        for i, mods in enumerate(self.postnet):
            h = mods[0](h)
            if len(mods) > 1:
                h = mods[1](h, mask)
            if i != n - 1:
                h = torch.tanh(h)
            h = F.dropout(h, self.dropout_rate, self.training)
            if mask is not None:
                h = torch.where(mask[..., None], h, 0.0)
        return h.to(xs.dtype)
