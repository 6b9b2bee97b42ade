"""VITS flows and the stochastic duration predictor (mirrors
seq2seq_vc_tpu/nn/flows.py), both directions.

Channel-last (B, T, C) as the JAX package. Module names follow the
reference torch code (``flows.N``, ``dds.convs.i.{0,2,5,7}``, ``post_*``),
so every weight of a trained predictor loads, including the posterior
(``post_*``) branch that only training runs. ``inverse=False`` is the NLL
(training) direction, which also returns each flow's log-determinant.
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
    """Flip along channels (parameterless; keeps the reference indices).
    Its log-determinant is 0."""

    def forward(self, x):
        return torch.flip(x, dims=(-1,))


def log_flow(x, x_mask, eps: float = 1e-5):
    """Forward log flow: (log(max(x, eps)) * mask, logdet (B,)).
    x: (B, T, C); x_mask: (B, T, 1)."""
    y = torch.log(torch.clamp(x, min=eps)) * x_mask
    return y, (-y).sum(dim=(1, 2))


class ElementwiseAffineFlow(torch.nn.Module):
    def __init__(self, channels: int, device=None, dtype=None):
        super().__init__()
        # reference layout (channels, 1)
        self.m = torch.nn.Parameter(torch.zeros(channels, 1, device=device, dtype=dtype))
        self.logs = torch.nn.Parameter(torch.zeros(channels, 1, device=device, dtype=dtype))

    def forward(self, x, x_mask, inverse: bool = True):
        """Inverse: x -> (x - m) / exp(logs). Forward: (y, logdet (B,))."""
        m, logs = self.m[:, 0], self.logs[:, 0]
        if not inverse:
            y = (m + torch.exp(logs) * x) * x_mask
            return y, (logs * x_mask).sum(dim=(1, 2))
        return (x - m) * torch.exp(-logs) * x_mask


class DilatedDepthSeparableConv(torch.nn.Module):
    """Residual stack of (depthwise dilated conv, LN, GELU, 1x1, LN, GELU).

    Each layer is a ModuleDict keyed like the reference Sequential's
    parameterised entries: 0 depthwise conv, 2 LN, 5 1x1 conv, 7 LN.
    """

    def __init__(self, channels: int, kernel_size: int, layers: int,
                 dropout_rate: float = 0.0, eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dropout_rate = dropout_rate
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
            x = x + F.dropout(y, self.dropout_rate, self.training)
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
        """x: (B, T, in_channels); x_mask: (B, T, 1). Inverse: y. Forward:
        (y, logdet (B,))."""
        xa, xb = x[..., : self.half], x[..., self.half:]
        h = self.dds_conv(self.input_conv(xa), x_mask, g=g)
        h = self.proj(h) * x_mask
        b, t, _ = xa.shape
        h = h.reshape(b, t, self.half, self.bins * 3 - 1).permute(0, 2, 1, 3)
        denom = math.sqrt(self.hidden_channels)
        uw = h[..., : self.bins] / denom
        uh = h[..., self.bins: 2 * self.bins] / denom
        ud = h[..., 2 * self.bins:]
        xb_t, logdet_abs = piecewise_rational_quadratic_transform(
            xb.transpose(1, 2), uw, uh, ud, inverse=inverse, tail_bound=self.tail_bound
        )
        y = torch.cat([xa, xb_t.transpose(1, 2)], dim=-1) * x_mask
        if inverse:
            return y
        return y, (logdet_abs.transpose(1, 2) * x_mask).sum(dim=(1, 2))


def _flow_list(channels, kernel_size, flows, layers, **kw):
    """[ElementwiseAffine, ConvFlow, Flip, ConvFlow, Flip, ...] as the reference."""
    mods = [ElementwiseAffineFlow(2, **kw)]
    for _ in range(flows):
        mods += [ConvFlow(2, channels, kernel_size, layers, **kw), Flip()]
    return torch.nn.ModuleList(mods)


def _standard_normal(shape, like, noise, generator):
    """``noise`` if given, else a standard-normal draw from ``generator`` on
    the generator's device (so one CPU generator gives the same numbers to a
    model on the card and one on the CPU), in ``like``'s device and dtype."""
    if noise is None:
        noise = torch.randn(
            *shape, generator=generator,
            device=like.device if generator is None else generator.device,
        )
    return noise.to(like.device, like.dtype)


def _flows_forward(flows, z, mask, g):
    """[affine, (conv, flip) x n] in order; returns (z, summed logdet (B,))."""
    z, logdet = flows[0](z, mask, inverse=False)
    for f in flows[1:]:
        if isinstance(f, Flip):
            z = f(z)
        else:
            z, ld = f(z, mask, g=g, inverse=False)
            logdet = logdet + ld
    return z, logdet


class StochasticDurationPredictor(torch.nn.Module):
    """VITS stochastic duration predictor.

    Training: ``nll(x, x_mask, w)`` -> per-item NLL (B,) of durations ``w``.
    Inference: ``forward(x, x_mask, noise_scale=s, noise=z)`` -> durations
    (B, T) via ``ceil(exp(logw))``. ``noise`` is the (B, T, 2)
    standard-normal draw (e_q in training, z in inference); without it one
    is drawn from ``generator`` on the generator's device (no draw at
    inference when s == 0). The DDS convs apply dropout in ``train()`` mode.
    """

    def __init__(self, channels: int = 192, kernel_size: int = 3, flows: int = 4,
                 dds_conv_layers: int = 3, in_channels: Optional[int] = None,
                 dropout_rate: float = 0.5, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        dds = (channels, kernel_size, dds_conv_layers, dropout_rate)
        self.pre = Conv1d(in_channels or channels, channels, 1, **kw)
        self.dds = DilatedDepthSeparableConv(*dds, **kw)
        self.proj = Conv1d(channels, channels, 1, **kw)
        self.flows = _flow_list(channels, kernel_size, flows, dds_conv_layers, **kw)
        self.post_pre = Conv1d(1, channels, 1, **kw)
        self.post_dds = DilatedDepthSeparableConv(*dds, **kw)
        self.post_proj = Conv1d(channels, channels, 1, **kw)
        self.post_flows = _flow_list(channels, kernel_size, flows, dds_conv_layers, **kw)

    def _condition(self, x, mask):
        """The conditioner, with the gradient to ``x`` stopped."""
        return self.proj(self.dds(self.pre(x.detach()), mask)) * mask

    def nll(self, x, x_mask, w, noise: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None):
        """Per-item NLL (B,) of durations ``w`` (B, T) given the
        conditioner x (B, T, C) and x_mask (B, T) True at valid tokens
        (seq2seq_vc_tpu/nn/flows.py:365-402)."""
        mask = x_mask[..., None].to(x.dtype)
        x = self._condition(x, mask)
        w = w[..., None].to(x.dtype)
        h_w = self.post_proj(self.post_dds(self.post_pre(w), mask)) * mask
        e_q = _standard_normal((x.shape[0], x.shape[1], 2), x, noise, generator) * mask
        z_q, logdet_q = _flows_forward(self.post_flows, e_q, mask, x + h_w)
        z_u, z1 = z_q[..., :1], z_q[..., 1:]
        u = torch.sigmoid(z_u) * mask
        z0 = (w - u) * mask
        logdet_q = logdet_q + ((F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * mask).sum(dim=(1, 2))
        half_log_2pi = 0.5 * math.log(2 * math.pi)
        logq = ((-half_log_2pi - 0.5 * e_q ** 2) * mask).sum(dim=(1, 2)) - logdet_q
        z0, logdet = log_flow(z0, mask)
        z, ld = _flows_forward(self.flows, torch.cat([z0, z1], dim=-1), mask, x)
        logdet = logdet + ld
        nll = ((half_log_2pi + 0.5 * z ** 2) * mask).sum(dim=(1, 2)) - logdet
        return nll + logq

    def log_durations(self, x, x_mask, noise_scale: float = 1.0,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
        """(B, T) log-durations: the flows run inverse from the noise."""
        mask = x_mask[..., None].to(x.dtype)
        x = self._condition(x, mask)
        if noise_scale == 0.0:
            z = torch.zeros(x.shape[0], x.shape[1], 2, device=x.device, dtype=x.dtype)
        else:
            z = _standard_normal((x.shape[0], x.shape[1], 2), x, noise, generator) * noise_scale
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
