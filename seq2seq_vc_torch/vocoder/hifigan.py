"""HiFi-GAN generator, discriminators, GAN losses and chunked synthesis
(mirrors seq2seq_vc_tpu/vocoder/hifigan.py).

Names are jik876's (``conv_pre``, ``ups.i``, ``resblocks.r.convs1.d``,
``convs2.d``, ``conv_post``; ``mpd``/``msd`` ``.discriminators.i.convs.j``
and ``conv_post``). ``ups.i`` is ``torch.nn.ConvTranspose1d(padding=(k-u)//2)``,
whose output equals the JAX package's full-VALID-then-crop
``ConvTranspose1dTorch``. Convolutions compute in ``compute_dtype``
(bfloat16 by default, as the JAX modules); waveforms and scores are float32.

Weight norm is flax's ``WeightNorm`` (``weight_norm_``): ``weight =
weight_v * rsqrt(sum(weight_v^2) + 1e-12) * weight_g``, the sum over every
axis but the output one, ``weight_g`` starting at 1. The discriminators
and the training form of the generator (``weight_norm=True``) keep it; the
inference generator holds it folded into a plain ``weight``, and
``load_hifigan_model`` folds a checkpoint's.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import load_config
from ..device import resolve_device
from .common import conv, read_generator_state

LRELU_SLOPE = 0.1


def weight_norm_(layer: torch.nn.Module, dim: int = 0) -> torch.nn.Module:
    """``layer``'s ``weight`` replaced by flax's weight norm over every axis
    but ``dim`` (its output axis: 0, or 1 for a ``ConvTranspose1d``):
    ``weight_v`` (the weight as it was) and ``weight_g`` (ones), with the
    bias zeroed, as flax initialises them. ``vocoder.common.conv``
    computes the weight."""
    v = layer.weight.detach()
    del layer.weight
    shape = [1] * v.ndim
    shape[dim] = v.shape[dim]
    layer.weight_g = torch.nn.Parameter(torch.ones(shape, device=v.device))
    layer.weight_v = torch.nn.Parameter(v)
    if layer.bias is not None:
        torch.nn.init.zeros_(layer.bias)
    return layer


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
    """Features (B, T, in_channels) -> waveform (B, T * prod(upsample_factors)).

    ``weight_norm=True`` gives the training form: every convolution keeps
    flax's weight norm (``weight_g``, ``weight_v``), as ``HifiganTrainer``
    trains it."""

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
        weight_norm: bool = False,
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
        if weight_norm:
            for layer in self.modules():
                if isinstance(layer, torch.nn.ConvTranspose1d):
                    weight_norm_(layer, dim=1)
                elif isinstance(layer, torch.nn.Conv1d):
                    weight_norm_(layer)

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


def same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax ``"SAME"`` padding of a length-``n`` axis for kernel ``k`` and
    stride ``s``: ceil(n / s) outputs, the odd sample of the pad on the
    right (k 41, s 2 on an even length: 19 left, 20 right)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class PeriodDiscriminator(torch.nn.Module):
    """The waveform reflect-padded to a multiple of ``period``, folded into
    (T / period, period), through stacked (k, 1) 2-D convolutions."""

    def __init__(self, period: int, compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.period = period
        self.compute_dtype = compute_dtype
        chans = (1, 32, 128, 512, 1024)
        self.convs = torch.nn.ModuleList(
            weight_norm_(torch.nn.Conv2d(cin, cout, (5, 1), (3, 1), padding=(2, 0),
                                         device=device))
            for cin, cout in zip(chans[:-1], chans[1:]))
        self.convs.append(weight_norm_(torch.nn.Conv2d(1024, 1024, (5, 1), padding=(2, 0),
                                                       device=device)))
        self.conv_post = weight_norm_(torch.nn.Conv2d(1024, 1, (3, 1), padding=(1, 0),
                                                      device=device))

    def forward(self, x: torch.Tensor):
        b, t = x.shape
        pad = (-t) % self.period
        if pad:
            x = F.pad(x[:, None], (0, pad), mode="reflect")[:, 0]
        h = x.reshape(b, 1, -1, self.period)
        fmaps = []
        for layer in self.convs:
            h = F.leaky_relu(conv(layer, h, self.compute_dtype), LRELU_SLOPE)
            fmaps.append(h)
        h = conv(self.conv_post, h, self.compute_dtype)
        fmaps.append(h)
        return h.reshape(b, -1).float(), fmaps


class MultiPeriodDiscriminator(torch.nn.Module):
    def __init__(self, periods: Tuple[int, ...] = (2, 3, 5, 7, 11),
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.discriminators = torch.nn.ModuleList(
            PeriodDiscriminator(p, compute_dtype, device) for p in periods)

    def forward(self, x):
        scores, fmaps = [], []
        for d in self.discriminators:
            s, f = d(x)
            scores.append(s)
            fmaps.append(f)
        return scores, fmaps


# (channels, kernel, stride, groups) of the scale discriminator's convs
SCALE_SPECS = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16), (512, 41, 4, 16),
               (1024, 41, 4, 16), (1024, 41, 1, 16), (1024, 5, 1, 1))


class ScaleDiscriminator(torch.nn.Module):
    """Grouped strided 1-D convolutions, each padded as flax's ``"SAME"``."""

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        cin = 1
        self.convs = torch.nn.ModuleList()
        for ch, k, s, groups in SCALE_SPECS:
            self.convs.append(weight_norm_(torch.nn.Conv1d(cin, ch, k, s, groups=groups,
                                                           device=device)))
            cin = ch
        self.conv_post = weight_norm_(torch.nn.Conv1d(cin, 1, 3, device=device))

    def _conv(self, layer, h):
        pad = same_pad(h.shape[-1], layer.kernel_size[0], layer.stride[0])
        return conv(layer, F.pad(h, pad), self.compute_dtype)

    def forward(self, x: torch.Tensor):
        h = x[:, None]
        fmaps = []
        for layer in self.convs:
            h = F.leaky_relu(self._conv(layer, h), LRELU_SLOPE)
            fmaps.append(h)
        h = self._conv(self.conv_post, h)
        fmaps.append(h)
        return h[:, 0].float(), fmaps


def edge_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, T // 2 + 1): edge-padded by 2, the means of 4-sample
    windows at stride 2 (``AvgPool1d(4, 2, 2)`` would pad with zeros)."""
    return F.pad(x[:, None], (2, 2), mode="replicate")[:, 0].unfold(1, 4, 2).mean(-1)


class MultiScaleDiscriminator(torch.nn.Module):
    def __init__(self, n_scales: int = 3, compute_dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.discriminators = torch.nn.ModuleList(
            ScaleDiscriminator(compute_dtype, device) for _ in range(n_scales))

    def forward(self, x):
        scores, fmaps = [], []
        h = x
        for i, d in enumerate(self.discriminators):
            if i > 0:
                h = edge_avg_pool(h)
            s, f = d(h)
            scores.append(s)
            fmaps.append(f)
        return scores, fmaps


class HifiganDiscriminator(torch.nn.Module):
    """The multi-period and multi-scale discriminators: waveform (B, T) ->
    (8 score tensors, 8 lists of feature maps)."""

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator(compute_dtype=compute_dtype, device=device)
        self.msd = MultiScaleDiscriminator(compute_dtype=compute_dtype, device=device)

    def forward(self, x):
        mpd_s, mpd_f = self.mpd(x)
        msd_s, msd_f = self.msd(x)
        return mpd_s + msd_s, mpd_f + msd_f


def discriminator_loss(real_scores, fake_scores):
    """LSGAN discriminator loss: (1-D(x))^2 + D(G(z))^2."""
    loss = 0.0
    for r, f in zip(real_scores, fake_scores):
        loss = loss + torch.mean((1.0 - r) ** 2) + torch.mean(f ** 2)
    return loss


def generator_adversarial_loss(fake_scores):
    """LSGAN generator loss: (1-D(G(z)))^2."""
    loss = 0.0
    for f in fake_scores:
        loss = loss + torch.mean((1.0 - f) ** 2)
    return loss


def feature_matching_loss(real_fmaps, fake_fmaps):
    """Mean absolute difference of every feature map, summed (in the maps'
    dtype, as in JAX)."""
    loss = 0.0
    for rfs, ffs in zip(real_fmaps, fake_fmaps):
        for r, f in zip(rfs, ffs):
            loss = loss + torch.mean(torch.abs(r - f))
    return loss


def chunked_generate(vocoder: HifiganGenerator, mel: torch.Tensor,
                     chunk_frames: int = 160, halo_frames: int = 8) -> torch.Tensor:
    """Overlap-halo chunked synthesis: (T, D) mel -> (T * hop,) waveform, or
    a (B, T, D) batch -> (B, T * hop), every item's chunks in one call.

    The utterance is cut into overlapping chunks synthesised as one batch
    and re-assembled by trimming the halos; interior samples match
    unchunked synthesis up to float tolerance once ``halo_frames`` exceeds
    the generator's receptive field.
    """
    if mel.dim() == 2:
        return chunked_generate(vocoder, mel[None], chunk_frames, halo_frames)[0]
    b, t, _ = mel.shape
    hop = int(np.prod(vocoder.upsample_factors))
    chunks = torch.cat([_chunks(m, chunk_frames, halo_frames) for m in mel])
    wavs = vocoder(chunks)[:, halo_frames * hop: (halo_frames + chunk_frames) * hop]
    return wavs.reshape(b, -1)[:, : t * hop]


def _chunks(mel: torch.Tensor, chunk_frames: int, halo_frames: int) -> torch.Tensor:
    """(T, D) -> (n_chunks, chunk_frames + 2 * halo_frames, D) windows,
    edge-padded so that halos at the borders see real context."""
    t = mel.shape[0]
    n_chunks = max((t + chunk_frames - 1) // chunk_frames, 1)
    t_pad = n_chunks * chunk_frames
    mel_p = F.pad(mel.T[None], (halo_frames, t_pad - t + halo_frames), mode="replicate")[0].T
    window = chunk_frames + 2 * halo_frames
    return mel_p.unfold(0, window, chunk_frames).transpose(1, 2)


def load_hifigan_model(checkpoint: str, config_path: Optional[str] = None,
                       device=None) -> HifiganGenerator:
    """An inference ``HifiganGenerator`` from a torch checkpoint: a state
    dict under the names above, or ``HifiganTrainer``'s bundle (its
    ``model`` then ``generator`` entry), weight norm folded
    (``vocoder.common.read_generator_state``), with the generator's
    arguments from the ``generator_params`` block of a YAML config (the
    defaults without one), on ``device`` (default: the card)."""
    device = resolve_device(device)
    params: Dict[str, Any] = {}
    if config_path:
        params = load_config(config_path).get("generator_params", {}) or {}
    model = HifiganGenerator(**params, device=device)
    model.load_state_dict(read_generator_state(checkpoint))
    return model.eval()


def load_hifigan_backend(checkpoint: str, config_path: Optional[str] = None, device=None):
    """A (T, in_channels) numpy -> (T * hop,) numpy waveform callable
    through ``chunked_generate`` (mirrors the JAX ``load_hifigan_backend``;
    also ``vocoder.get_vocoder``'s HiFi-GAN route), on ``device`` (default:
    the card)."""
    model = load_hifigan_model(checkpoint, config_path, device)
    device = model.conv_pre.weight.device

    @torch.no_grad()
    def backend(feats: np.ndarray) -> np.ndarray:
        mel = torch.as_tensor(np.asarray(feats, np.float32), device=device)
        return chunked_generate(model, mel).cpu().numpy()

    return backend
