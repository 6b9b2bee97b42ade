"""VITS flows and the stochastic duration predictor (mirrors
seq2seq_vc_tpu/nn/flows.py), inference direction.

Channel-last (B, T, C) as the JAX package. Module names follow the
reference torch code (``flows.N``, ``dds.convs.i.{0,2,5,7}``, ``post_*``),
so every weight of a trained predictor loads, including the posterior
(``post_*``) branch that only training runs. The NLL (training) direction
comes with the training slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .layers import Conv1d, LayerNorm

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _searchsorted(bin_locations, inputs, eps: float = 1e-6):
    bin_locations = bin_locations.clone()
    bin_locations[..., -1] += eps
    return (inputs[..., None] >= bin_locations).sum(dim=-1) - 1


def rational_quadratic_spline(
    inputs, unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
    inverse: bool = False, left: float = 0.0, right: float = 1.0,
    bottom: float = 0.0, top: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
):
    """Monotonic rational-quadratic spline (nflows formulation), vectorised."""
    num_bins = unnormalized_widths.shape[-1]

    widths = torch.softmax(unnormalized_widths, dim=-1)
    widths = min_bin_width + (1 - min_bin_width * num_bins) * widths
    cumwidths = F.pad(torch.cumsum(widths, dim=-1), (1, 0))
    cumwidths = (right - left) * cumwidths + left
    cumwidths[..., 0] = left
    cumwidths[..., -1] = right
    widths = cumwidths[..., 1:] - cumwidths[..., :-1]

    derivatives = min_derivative + F.softplus(unnormalized_derivatives)

    heights = torch.softmax(unnormalized_heights, dim=-1)
    heights = min_bin_height + (1 - min_bin_height * num_bins) * heights
    cumheights = F.pad(torch.cumsum(heights, dim=-1), (1, 0))
    cumheights = (top - bottom) * cumheights + bottom
    cumheights[..., 0] = bottom
    cumheights[..., -1] = top
    heights = cumheights[..., 1:] - cumheights[..., :-1]

    bins = cumheights if inverse else cumwidths
    bin_idx = torch.clamp(_searchsorted(bins, inputs), 0, num_bins - 1)[..., None]

    def take(x):
        return torch.gather(x, -1, bin_idx)[..., 0]

    input_cumwidths = take(cumwidths[..., :-1])
    input_bin_widths = take(widths)
    input_cumheights = take(cumheights[..., :-1])
    input_delta = take(heights / widths)
    input_derivatives = take(derivatives[..., :-1])
    input_derivatives_plus_one = take(derivatives[..., 1:])
    input_heights = take(heights)

    if inverse:
        a = (inputs - input_cumheights) * (
            input_derivatives + input_derivatives_plus_one - 2 * input_delta
        ) + input_heights * (input_delta - input_derivatives)
        b = input_heights * input_derivatives - (inputs - input_cumheights) * (
            input_derivatives + input_derivatives_plus_one - 2 * input_delta
        )
        c = -input_delta * (inputs - input_cumheights)
        discriminant = torch.clamp(b ** 2 - 4 * a * c, min=0.0)
        root = (2 * c) / (-b - torch.sqrt(discriminant))
        outputs = root * input_bin_widths + input_cumwidths
        theta_one_minus_theta = root * (1 - root)
        denominator = input_delta + (
            (input_derivatives + input_derivatives_plus_one - 2 * input_delta)
            * theta_one_minus_theta
        )
        derivative_numerator = input_delta ** 2 * (
            input_derivatives_plus_one * root ** 2
            + 2 * input_delta * theta_one_minus_theta
            + input_derivatives * (1 - root) ** 2
        )
        logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
        return outputs, -logabsdet
    theta = (inputs - input_cumwidths) / input_bin_widths
    theta_one_minus_theta = theta * (1 - theta)
    numerator = input_heights * (
        input_delta * theta ** 2 + input_derivatives * theta_one_minus_theta
    )
    denominator = input_delta + (
        (input_derivatives + input_derivatives_plus_one - 2 * input_delta)
        * theta_one_minus_theta
    )
    outputs = input_cumheights + numerator / denominator
    derivative_numerator = input_delta ** 2 * (
        input_derivatives_plus_one * theta ** 2
        + 2 * input_delta * theta_one_minus_theta
        + input_derivatives * (1 - theta) ** 2
    )
    logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
    return outputs, logabsdet


def piecewise_rational_quadratic_transform(
    inputs, unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
    inverse: bool = False, tail_bound: float = 5.0,
):
    """Spline inside [-tail_bound, tail_bound], identity linear tails outside."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.exp(1 - DEFAULT_MIN_DERIVATIVE) - 1)
    ud = F.pad(unnormalized_derivatives, (1, 1))
    ud[..., 0] = constant
    ud[..., -1] = constant
    out_in, ld_in = rational_quadratic_spline(
        torch.clamp(inputs, -tail_bound, tail_bound),
        unnormalized_widths, unnormalized_heights, ud, inverse=inverse,
        left=-tail_bound, right=tail_bound, bottom=-tail_bound, top=tail_bound,
    )
    return torch.where(inside, out_in, inputs), torch.where(inside, ld_in, 0.0)


class Flip(torch.nn.Module):
    """Flip along channels (parameterless; keeps the reference indices)."""

    def forward(self, x):
        return torch.flip(x, dims=(-1,))


class ElementwiseAffineFlow(torch.nn.Module):
    def __init__(self, channels: int, device=None, dtype=None):
        super().__init__()
        # reference layout (channels, 1)
        self.m = torch.nn.Parameter(torch.zeros(channels, 1, device=device, dtype=dtype))
        self.logs = torch.nn.Parameter(torch.zeros(channels, 1, device=device, dtype=dtype))

    def forward(self, x, x_mask, inverse: bool = True):
        if not inverse:
            raise NotImplementedError("the NLL direction comes with the training slice")
        return (x - self.m[:, 0]) * torch.exp(-self.logs[:, 0]) * x_mask


class DilatedDepthSeparableConv(torch.nn.Module):
    """Residual stack of (depthwise dilated conv, LN, GELU, 1x1, LN, GELU).

    Each layer is a ModuleDict keyed like the reference Sequential's
    parameterised entries: 0 depthwise conv, 2 LN, 5 1x1 conv, 7 LN.
    """

    def __init__(self, channels: int, kernel_size: int, layers: int,
                 eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.convs = torch.nn.ModuleList(
            torch.nn.ModuleDict({
                "0": Conv1d(channels, channels, kernel_size, groups=channels,
                            dilation=kernel_size ** i, **kw),
                "2": LayerNorm(channels, eps, **kw),
                "5": Conv1d(channels, channels, 1, **kw),
                "7": LayerNorm(channels, eps, **kw),
            })
            for i in range(layers)
        )

    def forward(self, x, x_mask, g=None):
        """x: (B, T, C); x_mask: (B, T, 1)."""
        if g is not None:
            x = x + g
        for layer in self.convs:
            y = F.gelu(layer["2"](layer["0"](x * x_mask)), approximate="tanh")
            y = F.gelu(layer["7"](layer["5"](y)), approximate="tanh")
            x = x + y
        return x * x_mask


class ConvFlow(torch.nn.Module):
    """Coupling flow with a rational-quadratic spline conditioner."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int,
                 layers: int, bins: int = 10, tail_bound: float = 5.0,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.half = in_channels // 2
        self.hidden_channels = hidden_channels
        self.bins = bins
        self.tail_bound = tail_bound
        self.input_conv = Conv1d(self.half, hidden_channels, 1, **kw)
        self.dds_conv = DilatedDepthSeparableConv(hidden_channels, kernel_size, layers, **kw)
        self.proj = Conv1d(hidden_channels, self.half * (bins * 3 - 1), 1, **kw)
        torch.nn.init.zeros_(self.proj.weight)
        torch.nn.init.zeros_(self.proj.bias)

    def forward(self, x, x_mask, g=None, inverse: bool = True):
        """x: (B, T, in_channels); x_mask: (B, T, 1)."""
        if not inverse:
            raise NotImplementedError("the NLL direction comes with the training slice")
        xa, xb = x[..., : self.half], x[..., self.half:]
        h = self.dds_conv(self.input_conv(xa), x_mask, g=g)
        h = self.proj(h) * x_mask
        b, t, _ = xa.shape
        h = h.reshape(b, t, self.half, self.bins * 3 - 1).permute(0, 2, 1, 3)
        denom = math.sqrt(self.hidden_channels)
        uw = h[..., : self.bins] / denom
        uh = h[..., self.bins: 2 * self.bins] / denom
        ud = h[..., 2 * self.bins:]
        xb_t, _ = piecewise_rational_quadratic_transform(
            xb.transpose(1, 2), uw, uh, ud, inverse=True, tail_bound=self.tail_bound
        )
        return torch.cat([xa, xb_t.transpose(1, 2)], dim=-1) * x_mask


def _flow_list(channels, kernel_size, flows, layers, **kw):
    """[ElementwiseAffine, ConvFlow, Flip, ConvFlow, Flip, ...] as the reference."""
    mods = [ElementwiseAffineFlow(2, **kw)]
    for _ in range(flows):
        mods += [ConvFlow(2, channels, kernel_size, layers, **kw), Flip()]
    return torch.nn.ModuleList(mods)


class StochasticDurationPredictor(torch.nn.Module):
    """VITS stochastic duration predictor, inference (inverse) direction.

    ``forward(x, x_mask, noise_scale=s, noise=z)`` -> durations (B, T) via
    ``ceil(exp(logw))``. ``noise`` is the (B, T, 2) standard-normal draw;
    without it one is drawn from ``generator`` on the generator's device (no
    draw when s == 0).
    """

    def __init__(self, channels: int = 192, kernel_size: int = 3, flows: int = 4,
                 dds_conv_layers: int = 3, in_channels: Optional[int] = None,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.pre = Conv1d(in_channels or channels, channels, 1, **kw)
        self.dds = DilatedDepthSeparableConv(channels, kernel_size, dds_conv_layers, **kw)
        self.proj = Conv1d(channels, channels, 1, **kw)
        self.flows = _flow_list(channels, kernel_size, flows, dds_conv_layers, **kw)
        self.post_pre = Conv1d(1, channels, 1, **kw)
        self.post_dds = DilatedDepthSeparableConv(channels, kernel_size, dds_conv_layers, **kw)
        self.post_proj = Conv1d(channels, channels, 1, **kw)
        self.post_flows = _flow_list(channels, kernel_size, flows, dds_conv_layers, **kw)

    def log_durations(self, x, x_mask, noise_scale: float = 1.0,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
        """(B, T) log-durations: the flows run inverse from the noise."""
        mask = x_mask[..., None].to(x.dtype)
        x = self.proj(self.dds(self.pre(x.detach()), mask)) * mask
        if noise_scale == 0.0:
            z = torch.zeros(x.shape[0], x.shape[1], 2, device=x.device, dtype=x.dtype)
        else:
            if noise is None:
                # drawn on the generator's device, so one CPU generator gives
                # the same noise to a model on the card and one on the CPU
                noise = torch.randn(
                    x.shape[0], x.shape[1], 2, generator=generator,
                    device=x.device if generator is None else generator.device,
                ).to(x.device, x.dtype)
            z = noise * noise_scale
        # reversed order, dropping the conv flow next to the affine (the
        # reference's "useless vflow" removal)
        conv_flows = list(self.flows)[1::2]
        for f in reversed(conv_flows[1:]):
            z = f(torch.flip(z, dims=(-1,)), mask, g=x, inverse=True)
        z = torch.flip(z, dims=(-1,))
        return self.flows[0](z, mask, inverse=True)[..., 0]

    def forward(self, x, x_mask, noise_scale: float = 1.0,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """x: (B, T, C) conditioner; x_mask: (B, T) True at valid tokens.
        Returns durations ceil(exp(logw)), 0 at padded tokens."""
        logw = self.log_durations(x, x_mask, noise_scale, noise, generator)
        return torch.ceil(torch.exp(logw) * x_mask)
