"""HiFi-GAN generator and chunked synthesis (mirrors
seq2seq_vc_tpu/vocoder/hifigan.py:70-102,227-258), inference.

Names are jik876's (``conv_pre``, ``ups.i``, ``resblocks.r.convs1.d``,
``convs2.d``, ``conv_post``); weight norm is folded into plain ``weight``
at load time. ``ups.i`` is ``torch.nn.ConvTranspose1d(padding=(k-u)//2)``,
whose output equals the JAX package's full-VALID-then-crop
``ConvTranspose1dTorch``. Convolutions compute in ``compute_dtype``
(bfloat16 by default, as the JAX generator); the waveform is float32.
``load_hifigan_model`` reads the port's checkpoint format.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import load_config
from ..device import resolve_device
from .common import conv

LRELU_SLOPE = 0.1


class ResBlock(torch.nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5), device=None):
        super().__init__()
        self.convs1 = torch.nn.ModuleList(
            torch.nn.Conv1d(channels, channels, kernel_size, dilation=d,
                            padding=d * (kernel_size - 1) // 2, device=device)
            for d in dilations
        )
        self.convs2 = torch.nn.ModuleList(
            torch.nn.Conv1d(channels, channels, kernel_size,
                            padding=(kernel_size - 1) // 2, device=device)
            for _ in dilations
        )

    def forward(self, x, dt):
        for c1, c2 in zip(self.convs1, self.convs2):
            y = conv(c1, F.leaky_relu(x, LRELU_SLOPE), dt)
            x = x + conv(c2, F.leaky_relu(y, LRELU_SLOPE), dt)
        return x


class HifiganGenerator(torch.nn.Module):
    """Features (B, T, in_channels) -> waveform (B, T * prod(upsample_factors))."""

    def __init__(
        self,
        in_channels: int = 256,
        resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
        resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11),
        upsample_kernel_sizes: Tuple[int, ...] = (20, 16, 4, 4),
        upsample_channels: int = 512,
        upsample_factors: Tuple[int, ...] = (10, 8, 2, 2),
        sample_rate: int = 16000,
        compute_dtype: torch.dtype = torch.bfloat16,
        device=None,
    ):
        super().__init__()
        self.upsample_factors = tuple(upsample_factors)
        self.num_kernels = len(resblock_kernel_sizes)
        self.sample_rate = sample_rate
        self.compute_dtype = compute_dtype
        self.conv_pre = torch.nn.Conv1d(in_channels, upsample_channels, 5, padding=2,
                                        device=device)
        self.ups = torch.nn.ModuleList()
        self.resblocks = torch.nn.ModuleList()
        ch_in = upsample_channels
        for i, (u, k) in enumerate(zip(upsample_factors, upsample_kernel_sizes)):
            ch = upsample_channels // (2 ** (i + 1))
            self.ups.append(torch.nn.ConvTranspose1d(
                ch_in, ch, k, u, padding=(k - u) // 2, device=device
            ))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(ResBlock(ch, rk, rd, device=device))
            ch_in = ch
        self.conv_post = torch.nn.Conv1d(ch_in, 1, 7, padding=3, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        h = conv(self.conv_pre, x.transpose(1, 2), dt)
        for i, up in enumerate(self.ups):
            h = F.leaky_relu(h, LRELU_SLOPE)
            h = conv(up, h, dt)
            z = None
            for j in range(self.num_kernels):
                r = self.resblocks[i * self.num_kernels + j](h, dt)
                z = r if z is None else z + r
            h = z / self.num_kernels
        h = conv(self.conv_post, F.leaky_relu(h), dt)
        return torch.tanh(h.float())[:, 0, :]


def chunked_generate(vocoder: HifiganGenerator, mel: torch.Tensor,
                     chunk_frames: int = 160, halo_frames: int = 8) -> torch.Tensor:
    """Overlap-halo chunked synthesis: (T, D) mel -> (T * hop,) waveform.

    The utterance is cut into overlapping chunks synthesised as one batch
    and re-assembled by trimming the halos; interior samples match
    unchunked synthesis up to float tolerance once ``halo_frames`` exceeds
    the generator's receptive field.
    """
    t, _ = mel.shape
    hop = int(np.prod(vocoder.upsample_factors))
    n_chunks = max((t + chunk_frames - 1) // chunk_frames, 1)
    t_pad = n_chunks * chunk_frames
    # edge-pad so halos at the borders see real context
    mel_p = F.pad(mel.T[None], (halo_frames, t_pad - t + halo_frames), mode="replicate")[0].T
    window = chunk_frames + 2 * halo_frames
    chunks = mel_p.unfold(0, window, chunk_frames).transpose(1, 2)  # (n, window, D)
    wavs = vocoder(chunks)  # (n_chunks, window * hop)
    core = wavs[:, halo_frames * hop: (halo_frames + chunk_frames) * hop]
    return core.reshape(-1)[: t * hop]


def load_hifigan_model(checkpoint: str, config_path: Optional[str] = None,
                       device=None) -> HifiganGenerator:
    """A ``HifiganGenerator`` from the port's checkpoint format: a
    ``torch.save`` state dict under the names above (weight norm folded),
    with the generator's arguments from the ``generator_params`` block of a
    YAML config (the defaults without one), on ``device`` (default: the
    card)."""
    device = resolve_device(device)
    params: Dict[str, Any] = {}
    if config_path:
        params = load_config(config_path).get("generator_params", {}) or {}
    model = HifiganGenerator(**params, device=device)
    model.load_state_dict(torch.load(checkpoint, map_location=device, weights_only=True))
    return model.eval()
