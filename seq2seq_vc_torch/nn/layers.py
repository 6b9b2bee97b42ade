"""Parameter layers that compute in a chosen dtype, as flax's ``dtype=``.

The JAX package keeps parameters in float32 and runs some layers in a
compute dtype (bfloat16 for the flagship); with no compute dtype, inputs
and parameters promote to the wider type. These subclasses keep PyTorch's
parameter names and layouts (``weight``, ``bias``) and add that rule. The
1-D convolutions take and return channel-last (B, T, C) tensors, the JAX
package's layout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _dtype(compute_dtype, x, w):
    return compute_dtype or torch.promote_types(x.dtype, w.dtype)


def _cast(t: Optional[torch.Tensor], dt):
    return None if t is None else t.to(dt)


class Linear(torch.nn.Linear):
    def __init__(self, in_features, out_features, bias=True, compute_dtype=None,
                 device=None, dtype=None):
        super().__init__(in_features, out_features, bias, device=device, dtype=dtype)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = _dtype(self.compute_dtype, x, self.weight)
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class LayerNorm(torch.nn.LayerNorm):
    """Statistics in float32; output in the compute dtype (or promoted)."""

    def __init__(self, n, eps, compute_dtype=None, device=None, dtype=None):
        super().__init__(n, eps=eps, device=device, dtype=dtype)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        y = F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.eps,
        )
        return y.to(_dtype(self.compute_dtype, x, self.weight))


class Conv1d(torch.nn.Conv1d):
    """Conv1d over channel-last input; ``padding`` defaults to flax's SAME
    at stride 1: dilation * (k - 1) // 2 on the left and the rest on the
    right, so an even kernel puts its odd pad sample on the right."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=None,
                 dilation=1, groups=1, bias=True, compute_dtype=None, device=None,
                 dtype=None):
        extra_right = 0
        if padding is None:
            total = dilation * (kernel_size - 1)
            padding, extra_right = total // 2, total % 2
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, bias, device=device, dtype=dtype)
        self.compute_dtype = compute_dtype
        self.extra_right = extra_right

    def forward(self, x):
        dt = _dtype(self.compute_dtype, x, self.weight)
        h = x.transpose(1, 2).to(dt)
        if self.extra_right:
            h = F.pad(h, (0, self.extra_right))
        y = F.conv1d(h, self.weight.to(dt), _cast(self.bias, dt),
                     self.stride, self.padding, self.dilation, self.groups)
        return y.transpose(1, 2)
