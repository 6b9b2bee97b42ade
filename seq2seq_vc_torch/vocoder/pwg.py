"""Parallel WaveGAN generator, inference (mirrors
seq2seq_vc_tpu/vocoder/pwg.py:22-127, 184-237).

Gaussian noise in, 30 gated residual blocks with dilations 2^(i % 10)
conditioned on the nearest-upsampled mel, a skip-sum head. Names are
``parallel_wavegan``'s (``first_conv``, ``conv_layers.{i}.{conv,
conv1x1_aux,conv1x1_out,conv1x1_skip}``, ``upsample_net.upsample.up_layers
.{k}``, ``last_conv_layers.{1,3}``), except the input conv, which is
``upsample_net.conv_in.conv`` as the JAX converter ``torch_pwg_to_flax``
reads it; ``load_pwg_model`` also reads ``parallel_wavegan``'s
``upsample_net.conv_in.weight``. As in the JAX module, that conv zero-pads
the mel ("SAME"). Each upsampling scale s repeats frames s times and
smooths them with one (1, 1, 1, 2s+1) kernel shared by every mel channel,
as the original's Conv2d does. Convolutions compute in ``compute_dtype``
(bfloat16 by default, as the JAX generator); the waveform is float32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .common import conv, generator_params, read_generator_state


class ResidualBlock(torch.nn.Module):
    """WaveNet gated residual block with aux conditioning."""

    def __init__(self, residual_channels: int = 64, gate_channels: int = 128,
                 skip_channels: int = 64, aux_channels: int = 80, kernel_size: int = 3,
                 dilation: int = 1):
        super().__init__()
        self.conv = torch.nn.Conv1d(residual_channels, gate_channels, kernel_size,
                                    padding=dilation * (kernel_size - 1) // 2, dilation=dilation)
        self.conv1x1_aux = torch.nn.Conv1d(aux_channels, gate_channels, 1, bias=False)
        self.conv1x1_out = torch.nn.Conv1d(gate_channels // 2, residual_channels, 1)
        self.conv1x1_skip = torch.nn.Conv1d(gate_channels // 2, skip_channels, 1)

    def forward(self, x, c, dt):
        """x: (B, residual, T); c: (B, aux, T) -> (residual out, skip)."""
        h = conv(self.conv, x, dt) + conv(self.conv1x1_aux, c, dt)
        a, b = h.chunk(2, dim=1)
        z = torch.tanh(a) * torch.sigmoid(b)
        res = conv(self.conv1x1_out, z, dt)
        return (x + res) * math.sqrt(0.5), conv(self.conv1x1_skip, z, dt)


class Stretch2d(torch.nn.Module):
    """Nearest repeat along time (the original's ``Stretch2d``; no weights)."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, c):
        return torch.repeat_interleave(c, self.scale, dim=-1)


class UpsampleNetwork(torch.nn.Module):
    """``up_layers``: a ``Stretch2d`` and a (1, 2s+1) smoothing Conv2d per
    scale s, over the mel as a one-channel image (B, 1, aux, T)."""

    def __init__(self, upsample_scales: Sequence[int]):
        super().__init__()
        self.up_layers = torch.nn.ModuleList()
        for s in upsample_scales:
            smooth = torch.nn.Conv2d(1, 1, (1, 2 * s + 1), padding=(0, s), bias=False)
            torch.nn.init.constant_(smooth.weight, 1.0 / (2 * s + 1))
            self.up_layers.extend([Stretch2d(s), smooth])

    def forward(self, c, dt):
        c = c.unsqueeze(1)
        for layer in self.up_layers:
            c = layer(c) if isinstance(layer, Stretch2d) else conv(layer, c, dt)
        return c.squeeze(1)


class ConvIn(torch.nn.Module):
    def __init__(self, aux_channels: int, aux_context_window: int):
        super().__init__()
        self.conv = torch.nn.Conv1d(aux_channels, aux_channels, 2 * aux_context_window + 1,
                                    padding=aux_context_window, bias=False)


class ConvInUpsampleNetwork(torch.nn.Module):
    def __init__(self, upsample_scales: Sequence[int], aux_channels: int,
                 aux_context_window: int):
        super().__init__()
        self.conv_in = ConvIn(aux_channels, aux_context_window)
        self.upsample = UpsampleNetwork(upsample_scales)

    def forward(self, c, dt):
        """(B, aux, T_mel) -> (B, aux, T_mel * prod(scales))."""
        return self.upsample(conv(self.conv_in.conv, c, dt), dt)


class ParallelWaveGANGenerator(torch.nn.Module):
    """Mel (B, T_mel, aux) -> waveform (B, T_mel * prod(upsample_scales))."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1, kernel_size: int = 3,
                 layers: int = 30, stacks: int = 3, residual_channels: int = 64,
                 gate_channels: int = 128, skip_channels: int = 64, aux_channels: int = 80,
                 aux_context_window: int = 2, upsample_scales: Sequence[int] = (4, 4, 4, 4),
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.in_channels = in_channels
        self.aux_channels = aux_channels
        self.upsample_scales = tuple(upsample_scales)
        self.compute_dtype = compute_dtype
        self.first_conv = torch.nn.Conv1d(in_channels, residual_channels, 1)
        self.upsample_net = ConvInUpsampleNetwork(upsample_scales, aux_channels,
                                                  aux_context_window)
        per_stack = layers // stacks
        self.conv_layers = torch.nn.ModuleList(
            ResidualBlock(residual_channels, gate_channels, skip_channels, aux_channels,
                          kernel_size, 2 ** (i % per_stack))
            for i in range(layers)
        )
        self.last_conv_layers = torch.nn.ModuleList([
            torch.nn.ReLU(), torch.nn.Conv1d(skip_channels, skip_channels, 1),
            torch.nn.ReLU(), torch.nn.Conv1d(skip_channels, out_channels, 1),
        ])

    @property
    def hop(self) -> int:
        return int(np.prod(self.upsample_scales))

    def forward(self, c: torch.Tensor, z: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``z``: (B, in_channels, T_wav) noise; drawn from ``generator`` (a
        CPU generator: the same noise on every device) when absent."""
        dt = self.compute_dtype
        B, T, _ = c.shape
        if z is None:
            z = torch.randn(B, self.in_channels, T * self.hop, generator=generator)
        c_up = self.upsample_net(c.transpose(1, 2), dt)
        x = conv(self.first_conv, z.to(c.device), dt)
        skips = 0.0
        for layer in self.conv_layers:
            x, s = layer(x, c_up, dt)
            skips = skips + s.float()
        h = (skips * math.sqrt(1.0 / len(self.conv_layers))).relu()
        h = conv(self.last_conv_layers[1], h, dt).relu()
        return conv(self.last_conv_layers[3], h, dt).float()[:, 0]


PWG_KEYS = ("layers", "stacks", "residual_channels", "gate_channels", "skip_channels",
            "aux_channels", "aux_context_window")


def load_pwg_model(checkpoint: str, config_path: Optional[str] = None,
                   device=None) -> ParallelWaveGANGenerator:
    """A ``ParallelWaveGANGenerator`` from a torch checkpoint in the
    ``parallel_wavegan`` layout (``common.read_generator_state``), its
    widths from the config's ``generator_params`` (the keys the JAX loader
    reads, ``upsample_params.upsample_scales`` included), on ``device``
    (default: the card)."""
    device = resolve_device(device)
    params = generator_params(config_path, PWG_KEYS + ("upsample_params",))
    upsample = params.pop("upsample_params", None) or {}
    if "upsample_scales" in upsample:
        params["upsample_scales"] = tuple(upsample["upsample_scales"])
    state = read_generator_state(checkpoint)
    if "upsample_net.conv_in.weight" in state:  # parallel_wavegan's own name
        state["upsample_net.conv_in.conv.weight"] = state.pop("upsample_net.conv_in.weight")
    model = ParallelWaveGANGenerator(**params)
    model.load_state_dict(state)
    return model.to(device).eval()
