"""Taco2-AR downstream: upstream latents -> mel (mirrors
seq2seq_vc_tpu/vocoder/taco2ar.py:30-363), stage 1 of the s3prl-vc
two-stage vocoder.

Linear resampling of the latents to the mel frame rate, a Tacotron2
encoder (Linear embed -> N x [conv5 + norm + ReLU + dropout] -> BLSTM) and
an autoregressive decoder (prenet on the previous mel frame, LSTM cells,
a projection of [encoder frame, decoder state]). Names are s3prl-vc's
(``encoder.embed``, ``encoder.convs.{i}.{0,1}``, ``encoder.blstm``,
``decoder.lstms.{i}``, ``decoder.prenet.prenet.{i}.0``, ``decoder.proj``),
so that the JAX converter ``convert_torch_taco2ar`` takes the port's
``state_dict()``; torch's LSTM gate order (i, f, g, o) is the JAX cell's.

The prenet's dropout stays on at inference, as in Tacotron2. Its masks
come from a CPU generator (the same masks on every device), drawn for the
whole decode at once; ``build_downstream`` seeds it with 0 on every call,
as the JAX package draws from ``PRNGKey(0)`` on every call, so a call
repeats itself (the masks cannot equal JAX's). The decode is one Python
step per output frame at the exact latent length: no bucket, since the
BLSTM reads the tail.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .common import read_generator_state


def linear_resample(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """(B, T, D) -> (B, out_len, D) linear interpolation (align_corners False)."""
    return F.interpolate(x.transpose(1, 2), size=out_len, mode="linear",
                         align_corners=False).transpose(1, 2)


def prenet_masks(generator: Optional[torch.Generator], steps: int, layers: int, batch: int,
                 units: int, rate: float) -> torch.Tensor:
    """(steps, layers, batch, units) dropout masks of the prenet's always-on
    dropout: 0 where a unit drops, 1 / (1 - rate) where it is kept."""
    keep = 1.0 - rate
    u = torch.rand(steps, layers, batch, units, generator=generator)
    return (u < keep).float() / keep


class Taco2AR(torch.nn.Module):
    """Latents (B, T, input_dim) -> mel (B, T', output_dim), T' = round(T /
    resample_ratio); ``resample_ratio`` = latent frame rate / mel frame
    rate. ``norm_type``: ``group_norm`` (one group) or ``batch_norm``
    (running statistics, as a checkpoint that holds them needs)."""

    def __init__(self, input_dim: int, output_dim: int = 80, resample_ratio: float = 1.0,
                 encoder_conv_layers: int = 3, encoder_conv_chans: int = 512,
                 encoder_conv_filts: int = 5, encoder_units: int = 512, decoder_layers: int = 2,
                 decoder_units: int = 1024, prenet_layers: int = 2, prenet_units: int = 256,
                 prenet_dropout_rate: float = 0.5, dropout_rate: float = 0.5,
                 norm_type: str = "group_norm"):
        super().__init__()
        if norm_type not in ("group_norm", "batch_norm"):
            raise ValueError(norm_type)
        self.output_dim = output_dim
        self.resample_ratio = resample_ratio
        self.prenet_dropout_rate = prenet_dropout_rate
        chans = encoder_conv_chans

        def norm():
            return (torch.nn.GroupNorm(1, chans, eps=1e-6) if norm_type == "group_norm"
                    else torch.nn.BatchNorm1d(chans))

        self.encoder = torch.nn.Module()
        self.encoder.embed = torch.nn.Linear(input_dim, chans)
        self.encoder.convs = torch.nn.ModuleList(
            torch.nn.Sequential(
                torch.nn.Conv1d(chans, chans, encoder_conv_filts,
                                padding=(encoder_conv_filts - 1) // 2, bias=False),
                norm(), torch.nn.ReLU(), torch.nn.Dropout(dropout_rate))
            for _ in range(encoder_conv_layers))
        self.encoder.blstm = torch.nn.LSTM(chans, encoder_units // 2, batch_first=True,
                                           bidirectional=True)
        self.decoder = torch.nn.Module()
        self.decoder.lstms = torch.nn.ModuleList(
            torch.nn.LSTMCell(encoder_units + prenet_units if i == 0 else decoder_units,
                              decoder_units)
            for i in range(decoder_layers))
        self.decoder.prenet = torch.nn.Module()
        self.decoder.prenet.prenet = torch.nn.ModuleList(
            torch.nn.Sequential(torch.nn.Linear(output_dim if i == 0 else prenet_units,
                                                prenet_units), torch.nn.ReLU())
            for i in range(prenet_layers))
        self.decoder.proj = torch.nn.Linear(encoder_units + decoder_units, output_dim)

    def encode(self, latents: torch.Tensor, t_out: int) -> torch.Tensor:
        x = self.encoder.embed(linear_resample(latents, t_out)).transpose(1, 2)
        for layer in self.encoder.convs:
            x = layer(x)
        return self.encoder.blstm(x.transpose(1, 2))[0]

    def forward(self, latents: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Greedy AR decode; the prenet's masks drawn from ``generator``."""
        t_out = max(int(round(latents.shape[1] / self.resample_ratio)), 1)
        enc = self.encode(latents, t_out)
        B = enc.shape[0]
        prenet = self.decoder.prenet.prenet
        masks = prenet_masks(generator, t_out, len(prenet), B, prenet[0][0].out_features,
                             self.prenet_dropout_rate).to(enc.device)
        states = [(enc.new_zeros(B, cell.hidden_size),) * 2 for cell in self.decoder.lstms]
        prev = enc.new_zeros(B, self.output_dim)
        outs = []
        for t in range(t_out):
            p = prev
            for i, layer in enumerate(prenet):
                p = layer(p) * masks[t, i]
            x = torch.cat([enc[:, t], p], dim=-1)
            for i, cell in enumerate(self.decoder.lstms):
                states[i] = cell(x, states[i])
                x = states[i][0]
            prev = self.decoder.proj(torch.cat([enc[:, t], x], dim=-1))
            outs.append(prev)
        return torch.stack(outs, dim=1)


def build_downstream(checkpoint: str, config: Dict[str, Any], stats_mean: np.ndarray,
                     stats_scale: np.ndarray, device=None):
    """Stage 1 of ``S3PRLFeat2Wav``: (T, input_dim) latents -> (T', num_mels)
    mel in the inner vocoder's domain (de-normalised with ``stats_*``), from
    an s3prl-vc torch checkpoint and its downstream config
    (``model_type``, ``num_mels``, ``model_params``, and the frame rates
    combined as seq2seq_vc_tpu/vocoder/taco2ar.py:326-329 combines them),
    on ``device`` (default: the card). ``batch_norm`` when the checkpoint
    holds running statistics, else ``group_norm``."""
    device = resolve_device(device)
    if config.get("model_type", "Taco2_AR") != "Taco2_AR":
        raise NotImplementedError(f"downstream model_type {config.get('model_type')!r}: "
                                  "only Taco2_AR is ported")
    state = read_generator_state(checkpoint)
    if "encoder.embed.weight" not in state:
        raise KeyError("checkpoint lacks 'encoder.embed.weight': not an s3prl-vc Taco2-AR "
                       f"state dict (keys: {sorted(state)[:8]}...)")
    upstream_rate = float(config.get("upstream_rate", 160))  # samples a frame at 16 kHz
    mel_per_latent = config["sampling_rate"] / config["hop_size"] * upstream_rate / 16000.0
    fields = inspect.signature(Taco2AR).parameters
    model = Taco2AR(
        input_dim=int(state["encoder.embed.weight"].shape[1]),
        output_dim=int(config.get("num_mels", 80)),
        resample_ratio=1.0 / mel_per_latent if mel_per_latent else 1.0,
        norm_type="batch_norm" if any(k.endswith("running_mean") for k in state)
        else "group_norm",
        **{k: v for k, v in (config.get("model_params") or {}).items() if k in fields})
    model.load_state_dict(state)
    model = model.to(device).eval()
    mean, scale = (torch.as_tensor(np.asarray(s, np.float32), device=device)
                   for s in (stats_mean, stats_scale))

    @torch.no_grad()
    def downstream(latents: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(latents, np.float32), device=device)[None]
        mel = model(x, generator=torch.Generator().manual_seed(0))[0]
        return (mel * scale + mean).cpu().numpy()

    return downstream
