"""MelGAN and StyleMelGAN generators, inference (mirror
seq2seq_vc_tpu/vocoder/melgan.py:32-258, 343-436).

Names are ``parallel_wavegan``'s: MelGAN's flat ``melgan.{idx}``
Sequential ([pad, conv] + per scale [act, transposed conv, S residual
stacks] + [act, pad, conv, tanh]; a stack's ``stack.{2,4}`` and
``skip_layer``), and StyleMelGAN's ``noise_upsample.{2i}``,
``blocks.{i}.{tade1,tade2}.{aux_conv,gated_conv}.0``,
``blocks.{i}.gated_conv{1,2}`` and ``output_conv.0``, so that the JAX
converters ``torch_melgan_to_flax`` and ``torch_style_melgan_to_flax``
take the port's ``state_dict()``. The transposed convolutions are
``torch.nn.ConvTranspose1d(kernel 2s, stride s, padding s//2 + s%2,
output_padding s%2)``: exactly T -> T*s, the same samples as the JAX
package's full-VALID-then-crop ``ConvTransposeTorchPad`` (left crop
s//2 + s%2, right s//2). Convolutions compute in ``compute_dtype``
(bfloat16 by default, as the JAX generators); the waveform is float32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .common import conv, generator_params, read_generator_state

_CONVS = (torch.nn.Conv1d, torch.nn.ConvTranspose1d)


def _run(layers, x, dt):
    """A Sequential whose convolutions (and residual stacks) compute in ``dt``."""
    for layer in layers:
        if isinstance(layer, _CONVS):
            x = conv(layer, x, dt)
        elif isinstance(layer, ResidualStack):
            x = layer(x, dt)
        else:
            x = layer(x)
    return x


def _upsample_conv(in_ch: int, out_ch: int, s: int) -> torch.nn.ConvTranspose1d:
    return torch.nn.ConvTranspose1d(in_ch, out_ch, 2 * s, stride=s, padding=s // 2 + s % 2,
                                    output_padding=s % 2)


class ResidualStack(torch.nn.Module):
    """leaky-relu -> reflect-pad dilated conv -> leaky-relu -> 1x1, plus a
    1x1 skip."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: int = 1):
        super().__init__()
        self.stack = torch.nn.Sequential(
            torch.nn.LeakyReLU(0.2),
            torch.nn.ReflectionPad1d((kernel_size - 1) // 2 * dilation),
            torch.nn.Conv1d(channels, channels, kernel_size, dilation=dilation),
            torch.nn.LeakyReLU(0.2),
            torch.nn.Conv1d(channels, channels, 1),
        )
        self.skip_layer = torch.nn.Conv1d(channels, channels, 1)

    def forward(self, x, dt):
        return _run(self.stack, x, dt) + conv(self.skip_layer, x, dt)


class MelGANGenerator(torch.nn.Module):
    """Mel (B, T, in_channels) -> waveform (B, T * prod(upsample_scales))."""

    def __init__(self, in_channels: int = 80, out_channels: int = 1, kernel_size: int = 7,
                 channels: int = 512, upsample_scales: Sequence[int] = (8, 8, 2, 2),
                 stack_kernel_size: int = 3, stacks: int = 3,
                 use_final_nonlinear_activation: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.upsample_scales = tuple(upsample_scales)
        self.compute_dtype = compute_dtype
        pad = (kernel_size - 1) // 2
        layers = [torch.nn.ReflectionPad1d(pad),
                  torch.nn.Conv1d(in_channels, channels, kernel_size)]
        ch = channels
        for s in upsample_scales:
            layers += [torch.nn.LeakyReLU(0.2), _upsample_conv(ch, ch // 2, s)]
            ch //= 2
            layers += [ResidualStack(ch, stack_kernel_size, stack_kernel_size ** j)
                       for j in range(stacks)]
        layers += [torch.nn.LeakyReLU(0.2), torch.nn.ReflectionPad1d(pad),
                   torch.nn.Conv1d(ch, out_channels, kernel_size)]
        if use_final_nonlinear_activation:
            layers.append(torch.nn.Tanh())
        self.melgan = torch.nn.Sequential(*layers)

    @property
    def hop(self) -> int:
        return int(np.prod(self.upsample_scales))

    def forward(self, c: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``generator``: unused, MelGAN draws no noise (a backend passes one
        to every generator)."""
        dt = self.compute_dtype
        return _run(self.melgan, c.transpose(1, 2).to(dt), dt).float()[:, 0]


# ------------------------------------------------------------- StyleMelGAN
class TADELayer(torch.nn.Module):
    """Instance-norm x, turn the (upsampled) condition into a per-frame
    scale and shift; returns the modulated x and the projected condition
    (the next layer's condition)."""

    def __init__(self, in_channels: int = 64, aux_channels: int = 80, kernel_size: int = 9,
                 upsample_factor: int = 2):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.upsample_factor = upsample_factor
        self.aux_conv = torch.nn.Sequential(
            torch.nn.Conv1d(aux_channels, in_channels, kernel_size, padding=pad))
        self.gated_conv = torch.nn.Sequential(
            torch.nn.Conv1d(in_channels, 2 * in_channels, kernel_size, padding=pad))

    def forward(self, x, c, dt):
        x = F.instance_norm(x.float(), eps=1e-5).to(dt)
        if self.upsample_factor > 1:
            c = torch.repeat_interleave(c, self.upsample_factor, dim=-1)
            x = torch.repeat_interleave(x, self.upsample_factor, dim=-1)
        c = conv(self.aux_conv[0], c, dt)
        gamma, beta = conv(self.gated_conv[0], c, dt).chunk(2, dim=1)
        return gamma * x + beta, c


class TADEResBlock(torch.nn.Module):
    """Two TADE layers, each followed by a gated conv (softmax or sigmoid
    gate times tanh), and the upsampled residual."""

    def __init__(self, in_channels: int = 64, aux_channels: int = 80, kernel_size: int = 9,
                 dilation: int = 2, upsample_factor: int = 2, gated_function: str = "softmax"):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.upsample_factor = upsample_factor
        if gated_function not in ("softmax", "sigmoid"):
            raise ValueError(f"gated_function {gated_function!r}")
        self.softmax = gated_function == "softmax"
        self.tade1 = TADELayer(in_channels, aux_channels, kernel_size, 1)
        self.gated_conv1 = torch.nn.Conv1d(in_channels, 2 * in_channels, kernel_size,
                                           padding=pad)
        self.tade2 = TADELayer(in_channels, in_channels, kernel_size, upsample_factor)
        self.gated_conv2 = torch.nn.Conv1d(in_channels, 2 * in_channels, kernel_size,
                                           dilation=dilation, padding=pad * dilation)

    def _gate(self, h):
        a, b = h.chunk(2, dim=1)
        return (a.softmax(dim=1) if self.softmax else a.sigmoid()) * b.tanh()

    def forward(self, x, c, dt):
        residual = x
        x, c = self.tade1(x, c, dt)
        x = self._gate(conv(self.gated_conv1, x, dt))
        x, c = self.tade2(x, c, dt)
        x = self._gate(conv(self.gated_conv2, x, dt))
        if self.upsample_factor > 1:
            residual = torch.repeat_interleave(residual, self.upsample_factor, dim=-1)
        return residual + x, c


class StyleMelGANGenerator(torch.nn.Module):
    """Mel (B, T, aux) -> waveform (B, T * prod(upsample_scales)).

    Noise (B, in_channels, ceil(T / prod(noise_upsample_scales))) is
    upsampled by transposed convs to >= T frames, the mel is replicate-padded
    to that length, both go through the TADE blocks, and the waveform is
    trimmed to T * prod(upsample_scales) samples."""

    def __init__(self, in_channels: int = 128, aux_channels: int = 80, channels: int = 64,
                 out_channels: int = 1, kernel_size: int = 9, dilation: int = 2,
                 noise_upsample_scales: Sequence[int] = (11, 2, 2, 2),
                 upsample_scales: Sequence[int] = (2, 2, 2, 2, 2, 2, 2, 2, 1),
                 gated_function: str = "softmax", compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.in_channels = in_channels
        self.aux_channels = aux_channels
        self.noise_upsample_scales = tuple(noise_upsample_scales)
        self.upsample_scales = tuple(upsample_scales)
        self.compute_dtype = compute_dtype
        layers, ch = [], in_channels
        for s in noise_upsample_scales:
            layers += [_upsample_conv(ch, channels, s), torch.nn.LeakyReLU(0.2)]
            ch = channels
        self.noise_upsample = torch.nn.Sequential(*layers)
        self.blocks = torch.nn.ModuleList()
        aux = aux_channels
        for s in upsample_scales:
            self.blocks.append(TADEResBlock(channels, aux, kernel_size, dilation, s,
                                            gated_function))
            aux = channels
        self.output_conv = torch.nn.Sequential(
            torch.nn.Conv1d(channels, out_channels, kernel_size, padding=(kernel_size - 1) // 2),
            torch.nn.Tanh())

    @property
    def hop(self) -> int:
        return int(np.prod(self.upsample_scales))

    def forward(self, c: torch.Tensor, z: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``z``: (B, in_channels, ceil(T / noise factor)) noise; drawn from
        ``generator`` (a CPU generator: the same noise on every device) when
        absent."""
        dt = self.compute_dtype
        B, T, _ = c.shape
        if z is None:
            frames = math.ceil(T / int(np.prod(self.noise_upsample_scales)))
            z = torch.randn(B, self.in_channels, frames, generator=generator)
        x = _run(self.noise_upsample, z.to(c.device), dt)
        c = F.pad(c.transpose(1, 2), (0, x.shape[-1] - T), mode="replicate").to(dt)
        for block in self.blocks:
            x, c = block(x, c, dt)
        return _run(self.output_conv, x, dt).float()[:, 0, : T * self.hop]


MELGAN_KEYS = ("in_channels", "out_channels", "kernel_size", "channels", "upsample_scales",
               "stack_kernel_size", "stacks", "use_final_nonlinear_activation")
STYLE_MELGAN_KEYS = ("in_channels", "aux_channels", "channels", "out_channels", "kernel_size",
                     "dilation", "noise_upsample_scales", "upsample_scales", "gated_function")


def load_melgan_model(checkpoint: str, config_path: Optional[str] = None, device=None,
                      style: bool = False):
    """A ``MelGANGenerator`` (``style``: a ``StyleMelGANGenerator``) from a
    torch checkpoint in the ``parallel_wavegan`` layout, its widths from the
    keys of the config's ``generator_params`` that the JAX loader reads, on
    ``device`` (default: the card)."""
    device = resolve_device(device)
    cls, keys = (StyleMelGANGenerator, STYLE_MELGAN_KEYS) if style else \
        (MelGANGenerator, MELGAN_KEYS)
    model = cls(**generator_params(config_path, keys))
    model.load_state_dict(read_generator_state(checkpoint))
    return model.to(device).eval()
