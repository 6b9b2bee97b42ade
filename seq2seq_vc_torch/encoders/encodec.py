"""EnCodec-24kHz's SEANet encoder and decoder (mirrors
seq2seq_vc_tpu/encoders/encodec.py).

The recipes take EnCodec's *continuous* 128-d encoder embeddings as
features (75 Hz at 24 kHz; the quantizer is never used) and decode
converted ones with the SEANet decoder. Architecture (the module
constants below): Conv(1->32, k7) -> 4x [ResnetBlock -> ELU -> DownConv(k
2r, s r)] with ratios (2, 4, 5, 8) and channel doubling -> 2-layer
residual LSTM(512) -> ELU -> Conv(512->128, k7); the decoder mirrors it
with transposed convs (ratios (8, 5, 4, 2)), each trimmed of ``kernel -
stride`` samples on the right. Every conv is causal: reflect padding of
``kernel - stride`` on the left and the few samples on the right that make
the last window whole (``_causal_pad``).

The modules hold HuggingFace ``transformers.EncodecModel``'s names
(``layers.N.conv``, ``layers.N.block.1.conv``, ``layers.N.shortcut.conv``,
``layers.13.lstm``), so a checkpoint loads by name after ``read_encodec_state``
has mapped the facebookresearch names (``encoder.model.N.conv.conv``) onto
them and folded weight norm (HF ``parametrizations.weight.original{0,1}``
or ``weight_{g,v}``) into plain weights.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..dsp.stft import reflect_pad
from ..vocoder.common import fold_weight_norm

SAMPLE_RATE = 24000
EMBED_DIM = 128
NUM_FILTERS = 32
RATIOS = (8, 5, 4, 2)  # hop = prod = 320 -> 75 Hz
HOP = 320  # samples a latent frame (T_latents = ceil(n / HOP))
KERNEL = 7
LAST_KERNEL = 7
RESID_KERNEL = 3
COMPRESS = 2
LSTM_LAYERS = 2
ENCODE_BUCKET = 16 * HOP  # the samples preprocess pads an utterance to a multiple of
DECODE_BUCKET = 64  # the latent frames the vocoder pads to a multiple of


def _causal_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """HF ``EncodecConv1d``'s padding of x (B, C, T) (every conv here has
    dilation 1): ``kernel - stride`` reflected on the left, and on the right
    what makes the last window whole."""
    pad_total = kernel - stride
    length = x.shape[-1]
    n_frames = (length - kernel + pad_total) / stride + 1
    extra = (math.ceil(n_frames) - 1) * stride + kernel - pad_total - length
    return reflect_pad(x, pad_total, extra)


class _Conv(torch.nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__()
        self.conv = torch.nn.Conv1d(cin, cout, kernel, stride)

    def forward(self, x):
        return self.conv(_causal_pad(x, self.conv.kernel_size[0], self.conv.stride[0]))


class _ConvTranspose(torch.nn.Module):
    """ConvTranspose1d with the causal trim of ``kernel - stride`` samples
    on the right."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int):
        super().__init__()
        self.conv = torch.nn.ConvTranspose1d(cin, cout, kernel, stride)

    def forward(self, x):
        y = self.conv(x)
        trim = self.conv.kernel_size[0] - self.conv.stride[0]
        return y[..., : y.shape[-1] - trim] if trim > 0 else y


class _ResnetBlock(torch.nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        hidden = dim // COMPRESS
        self.block = torch.nn.ModuleList([torch.nn.ELU(), _Conv(dim, hidden, RESID_KERNEL),
                                          torch.nn.ELU(), _Conv(hidden, dim, 1)])
        self.shortcut = _Conv(dim, dim, 1)

    def forward(self, x):
        h = x
        for layer in self.block:
            h = layer(h)
        return self.shortcut(x) + h


class _LSTM(torch.nn.Module):
    """Two LSTM layers (gates i, f, g, o) with a residual around both."""

    def __init__(self, dim: int):
        super().__init__()
        self.lstm = torch.nn.LSTM(dim, dim, LSTM_LAYERS)

    def forward(self, x):  # (B, C, T)
        y = x.permute(2, 0, 1)
        return (self.lstm(y)[0] + y).permute(1, 2, 0)


class EncodecEncoder(torch.nn.Module):
    """(B, n) 24 kHz mono in [-1, 1] -> (B, ceil(n / 320), 128) embeddings."""

    def __init__(self):
        super().__init__()
        layers = [_Conv(1, NUM_FILTERS, KERNEL)]
        dim = NUM_FILTERS
        for ratio in reversed(RATIOS):
            layers += [_ResnetBlock(dim), torch.nn.ELU(), _Conv(dim, 2 * dim, 2 * ratio, ratio)]
            dim *= 2
        layers += [_LSTM(dim), torch.nn.ELU(), _Conv(dim, EMBED_DIM, LAST_KERNEL)]
        self.layers = torch.nn.ModuleList(layers)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None]
        for layer in self.layers:
            x = layer(x)
        return x.transpose(1, 2)


class EncodecDecoder(torch.nn.Module):
    """(B, T, 128) embeddings -> (B, T * 320) 24 kHz waveform."""

    def __init__(self):
        super().__init__()
        dim = NUM_FILTERS * 2 ** len(RATIOS)  # 512
        layers = [_Conv(EMBED_DIM, dim, KERNEL), _LSTM(dim)]
        for ratio in RATIOS:
            layers += [torch.nn.ELU(), _ConvTranspose(dim, dim // 2, 2 * ratio, ratio),
                       _ResnetBlock(dim // 2)]
            dim //= 2
        layers += [torch.nn.ELU(), _Conv(dim, 1, LAST_KERNEL)]
        self.layers = torch.nn.ModuleList(layers)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        x = emb.transpose(1, 2)
        for layer in self.layers:
            x = layer(x)
        return x[:, 0]


def read_encodec_state(checkpoint: str, part: str) -> Dict[str, torch.Tensor]:
    """The ``part`` ("encoder" or "decoder") of a torch EnCodec checkpoint
    (a state_dict, one under ``state_dict``, HF or facebookresearch names)
    as the state_dict of ``EncodecEncoder`` / ``EncodecDecoder``: weight
    norm folded, on the CPU; read with ``weights_only=True``."""
    obj = torch.load(checkpoint, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    state = {}
    for key, value in obj.items():
        if not key.startswith(f"{part}."):
            continue
        key = key[len(part) + 1:]
        if key.startswith("model."):  # facebookresearch
            key = "layers." + key[len("model."):]
        key = key.replace(".conv.conv.", ".conv.").replace(".convtr.convtr.", ".conv.")
        key = key.replace(".parametrizations.weight.original0", ".weight_g")
        key = key.replace(".parametrizations.weight.original1", ".weight_v")
        state[key] = value.float()
    return fold_weight_norm(state)


def _load(model: torch.nn.Module, part: str, checkpoint: str, device) -> torch.nn.Module:
    device = resolve_device(device)
    model.load_state_dict(read_encodec_state(checkpoint, part))
    return model.to(device).eval()


def load_encodec(checkpoint: str, device=None) -> EncodecEncoder:
    """The encoder of a torch EnCodec checkpoint, on ``device`` (default:
    the card)."""
    return _load(EncodecEncoder(), "encoder", checkpoint, device)


def load_encodec_decoder(checkpoint: str, device=None) -> EncodecDecoder:
    """The decoder of a torch EnCodec checkpoint, on ``device`` (default:
    the card)."""
    return _load(EncodecDecoder(), "decoder", checkpoint, device)


@torch.no_grad()
def encode(model: EncodecEncoder, wav) -> torch.Tensor:
    """(n,) 24 kHz samples -> (ceil(n / 320), 128) float32 embeddings on the
    model's device, as the JAX ``preprocess`` extracts them: the wav
    zero-padded to a multiple of ``ENCODE_BUCKET`` samples, so the last,
    partial frame sees zeros, then trimmed."""
    device = next(model.parameters()).device
    x = torch.as_tensor(wav, dtype=torch.float32, device=device)
    n_frames = -(-x.shape[0] // HOP)
    x = F.pad(x, (0, -x.shape[0] % ENCODE_BUCKET))
    return model(x[None])[0, :n_frames]
