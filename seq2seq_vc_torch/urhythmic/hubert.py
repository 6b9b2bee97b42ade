"""HuBERT-soft content encoder (mirrors seq2seq_vc_tpu/urhythmic/hubert.py),
float32.

HuBERT-base (CNN wave encoder -> feature projection -> conv-positional
post-LN transformer encoder) and the soft head (a 768 -> 256 projection for
soft units and a 100-cluster label embedding whose scaled cosine
similarities give the discrete-unit logits). Parameter names are
bshall/hubert's (``feature_extractor.conv{i}``, ``norm0``,
``feature_projection``, ``positional_embedding.conv``, ``norm``,
``encoder.layers.{i}`` as ``torch.nn.TransformerEncoderLayer``, ``proj``,
``label_embedding``), with the positional conv's weight norm folded, so the
JAX package's ``convert_torch_hubert`` reads a ``state_dict`` of this
module as it is.

The masked forward (``lengths``) makes a tail-padded batch give the
exact-length outputs on each row's valid frame prefix: the instance norm
takes its statistics over the first ``n_valid`` frames, padded frames are
zeroed before the positional conv, and padded keys are filled with -1e9
before the softmax. The attention is dense, as the JAX package's is.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

# hubert-base constants (facebook/hubert-base-ls960)
CONV_DIM = (512, 512, 512, 512, 512, 512, 512)
CONV_KERNEL = (10, 3, 3, 3, 3, 2, 2)
CONV_STRIDE = (5, 2, 2, 2, 2, 2, 2)
HIDDEN = 768
N_LAYERS = 12
N_HEADS = 12
FFN = 3072
LN_EPS = 1e-5
POS_CONV_KERNEL = 128
POS_CONV_GROUPS = 16
SOFT_DIM = 256
N_CLUSTERS = 100
LOGIT_TEMP = 0.1
SAMPLING_RATE = 16000
HOP = 320  # total feature-extractor stride
UNITS_PAD = (400 - HOP) // 2  # samples ``units`` pads on each side
MASK_FILL = -1e9  # the logit of a padded key (not -inf, as in JAX)


def conv_stack_frames(n):
    """Valid output frame count of the conv stack for ``n`` input samples
    (unpadded convs: every returned frame reads only the first ``n``
    samples). Works on ints, integer arrays and tensors."""
    for k, s in zip(CONV_KERNEL, CONV_STRIDE):
        n = (n - k) // s + 1
    return n


def _valid(n_valid: torch.Tensor, length: int) -> torch.Tensor:
    """(B, length) True on each row's first ``n_valid`` frames."""
    return torch.arange(length, device=n_valid.device)[None, :] < n_valid[:, None]


class FeatureExtractor(torch.nn.Module):
    """7 strided convs over the raw waveform; an instance norm (GroupNorm
    with a group a channel) after the first, exact GELU after each."""

    def __init__(self, device=None):
        super().__init__()
        for i, (dim, k, s) in enumerate(zip(CONV_DIM, CONV_KERNEL, CONV_STRIDE)):
            cin = 1 if i == 0 else CONV_DIM[i - 1]
            setattr(self, f"conv{i}", torch.nn.Conv1d(cin, dim, k, s, bias=False, device=device))
        self.norm0 = torch.nn.GroupNorm(CONV_DIM[0], CONV_DIM[0], device=device)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """x (B, T) -> (B, N, 512)."""
        h = x[:, None, :]
        n_valid = lengths
        for i, (k, s) in enumerate(zip(CONV_KERNEL, CONV_STRIDE)):
            h = getattr(self, f"conv{i}")(h)
            n_valid = (n_valid - k) // s + 1
            if i == 0:
                h = self._instance_norm(h, n_valid)
            h = F.gelu(h)
        return h.transpose(1, 2)

    def _instance_norm(self, h: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
        """Per (item, channel) norm over the first ``n_valid`` frames,
        two-pass variance, eps 1e-5."""
        mask = _valid(n_valid, h.shape[2])[:, None, :].to(h.dtype)
        cnt = n_valid.clamp(min=1).to(h.dtype)[:, None, None]
        mean = (h * mask).sum(2, keepdim=True) / cnt
        var = ((h - mean).square() * mask).sum(2, keepdim=True) / cnt
        h = (h - mean) * torch.rsqrt(var + LN_EPS)
        return h * self.norm0.weight[:, None] + self.norm0.bias[:, None]


class FeatureProjection(torch.nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.norm = torch.nn.LayerNorm(CONV_DIM[-1], eps=LN_EPS, device=device)
        self.projection = torch.nn.Linear(CONV_DIM[-1], HIDDEN, device=device)

    def forward(self, x):
        return self.projection(self.norm(x))


class PositionalConvEmbedding(torch.nn.Module):
    """The even 128-tap grouped conv, padded 64 a side; its last frame is
    dropped (HF's ``HubertSamePadLayer``)."""

    def __init__(self, device=None):
        super().__init__()
        self.conv = torch.nn.Conv1d(HIDDEN, HIDDEN, POS_CONV_KERNEL, padding=POS_CONV_KERNEL // 2,
                                    groups=POS_CONV_GROUPS, device=device)

    def forward(self, x):
        pos = self.conv(x.transpose(1, 2))
        if POS_CONV_KERNEL % 2 == 0:
            pos = pos[:, :, :-1]
        return F.gelu(pos).transpose(1, 2)


class SelfAttention(torch.nn.Module):
    """``torch.nn.MultiheadAttention``'s parameters (packed q, k, v), dense
    float32 logits with padded keys at -1e9."""

    def __init__(self, device=None):
        super().__init__()
        self.in_proj_weight = torch.nn.Parameter(torch.empty(3 * HIDDEN, HIDDEN, device=device))
        self.in_proj_bias = torch.nn.Parameter(torch.zeros(3 * HIDDEN, device=device))
        self.out_proj = torch.nn.Linear(HIDDEN, HIDDEN, device=device)
        torch.nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor]) -> torch.Tensor:
        B, T, _ = x.shape
        d_k = HIDDEN // N_HEADS
        q, k, v = (t.reshape(B, T, N_HEADS, d_k).transpose(1, 2)
                   for t in F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, -1))
        logits = (q / math.sqrt(d_k)) @ k.transpose(-1, -2)
        if key_mask is not None:
            logits = logits.masked_fill(~key_mask[:, None, None, :], MASK_FILL)
        o = logits.softmax(-1) @ v
        return self.out_proj(o.transpose(1, 2).reshape(B, T, HIDDEN))


class EncoderLayer(torch.nn.Module):
    """Post-LN layer with ``torch.nn.TransformerEncoderLayer``'s names."""

    def __init__(self, device=None):
        super().__init__()
        self.self_attn = SelfAttention(device)
        self.linear1 = torch.nn.Linear(HIDDEN, FFN, device=device)
        self.linear2 = torch.nn.Linear(FFN, HIDDEN, device=device)
        self.norm1 = torch.nn.LayerNorm(HIDDEN, eps=LN_EPS, device=device)
        self.norm2 = torch.nn.LayerNorm(HIDDEN, eps=LN_EPS, device=device)

    def forward(self, x, key_mask):
        x = self.norm1(x + self.self_attn(x, key_mask))
        return self.norm2(x + self.linear2(F.gelu(self.linear1(x))))


class Encoder(torch.nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.layers = torch.nn.ModuleList(EncoderLayer(device) for _ in range(N_LAYERS))


class HubertSoft(torch.nn.Module):
    """HuBERT-soft: soft units and discrete-unit logits."""

    def __init__(self, device=None):
        super().__init__()
        self.feature_extractor = FeatureExtractor(device)
        self.feature_projection = FeatureProjection(device)
        self.positional_embedding = PositionalConvEmbedding(device)
        self.norm = torch.nn.LayerNorm(HIDDEN, eps=LN_EPS, device=device)
        self.encoder = Encoder(device)
        self.proj = torch.nn.Linear(HIDDEN, SOFT_DIM, device=device)
        self.label_embedding = torch.nn.Embedding(N_CLUSTERS, SOFT_DIM, device=device)

    def encode(self, wav: torch.Tensor, output_layer: Optional[int] = None,
               lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """wav (B, T) in [-1, 1] -> hidden states (B, N, 768); with
        ``output_layer=k`` the k-th layer's output (1-based). ``lengths``
        (B,) valid sample counts of a tail-padded batch: the valid frame
        prefix (``conv_stack_frames(lengths)``) then equals each row's
        exact-length forward."""
        masked = lengths is not None
        if not masked:
            lengths = torch.full((wav.shape[0],), wav.shape[1], device=wav.device)
        h = self.feature_projection(self.feature_extractor(wav, lengths))
        key_mask = None
        if masked:
            key_mask = _valid(conv_stack_frames(lengths), h.shape[1])
            # the exact run's positional conv sees zeros past the end
            h = h.masked_fill(~key_mask[..., None], 0.0)
        h = self.norm(h + self.positional_embedding(h))
        for i, layer in enumerate(self.encoder.layers):
            h = layer(h, key_mask)
            if output_layer is not None and i + 1 == output_layer:
                return h
        return h

    def units(self, wav: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """wav (B, T) -> soft units (B, N, 256); pads 40 samples a side as
        bshall's ``HubertSoft.units``."""
        wav = F.pad(wav, (UNITS_PAD, UNITS_PAD))
        if lengths is not None:
            lengths = lengths + 2 * UNITS_PAD
        return self.proj(self.encode(wav, lengths=lengths))

    def logits(self, units: torch.Tensor) -> torch.Tensor:
        """Cosine similarity to the cluster embeddings over the temperature
        (norms clipped at 1e-8)."""
        u = units / torch.linalg.vector_norm(units, dim=-1, keepdim=True).clamp(min=1e-8)
        e = self.label_embedding.weight
        e = e / torch.linalg.vector_norm(e, dim=-1, keepdim=True).clamp(min=1e-8)
        return u @ e.T / LOGIT_TEMP

    def forward(self, wav, lengths=None) -> Tuple[torch.Tensor, torch.Tensor]:
        units = self.units(wav, lengths)
        return units, self.logits(units).log_softmax(-1)


# HF ``HubertModel`` module paths -> this module's
_HF_RENAMES = (
    ("feature_extractor.conv_layers.0.layer_norm.", "feature_extractor.norm0."),
    ("feature_projection.layer_norm.", "feature_projection.norm."),
    ("encoder.pos_conv_embed.conv.parametrizations.weight.original0",
     "positional_embedding.conv.weight_g"),
    ("encoder.pos_conv_embed.conv.parametrizations.weight.original1",
     "positional_embedding.conv.weight_v"),
    ("encoder.pos_conv_embed.", "positional_embedding."),
    ("encoder.layer_norm.", "norm."),
)
_HF_LAYER_RENAMES = (
    ("attention.out_proj.", "self_attn.out_proj."),
    ("layer_norm.", "norm1."),
    ("final_layer_norm.", "norm2."),
    ("feed_forward.intermediate_dense.", "linear1."),
    ("feed_forward.output_dense.", "linear2."),
)


def _rename_hf(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """HF naming -> bshall naming; q, k, v packed into ``in_proj``."""
    out = {}
    for key, value in sd.items():
        key = key.removeprefix("hubert.")
        if key.startswith("feature_extractor.conv_layers.") and ".conv." in key:
            i = key.split(".")[2]
            key = f"feature_extractor.conv{i}.{key.rsplit('.', 1)[1]}"
        for old, new in _HF_RENAMES:
            if key.startswith(old):
                key = new + key[len(old):]
                break
        if key.startswith("encoder.layers."):
            head, rest = key.split(".", 3)[:3], key.split(".", 3)[3]
            for old, new in _HF_LAYER_RENAMES:
                if rest.startswith(old):
                    rest = new + rest[len(old):]
                    break
            key = ".".join(head + [rest])
        out[key] = value
    for i in range(N_LAYERS):
        p = f"encoder.layers.{i}"
        if f"{p}.attention.q_proj.weight" in out:
            for leaf in ("weight", "bias"):
                out[f"{p}.self_attn.in_proj_{leaf}"] = torch.cat(
                    [out.pop(f"{p}.attention.{n}_proj.{leaf}") for n in "qkv"])
    return out


def hubert_soft_weights(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A torch HuBERT(-soft) state dict in bshall or HF ``HubertModel``
    naming -> this module's names, float32: the positional conv's weight
    norm folded (the norm over the weight's axes 0 and 1, one a tap,
    clipped at 1e-12), ``masked_spec_embed`` dropped, a missing soft head
    (an HF base model) zero-filled."""
    sd = {k.removeprefix("module."): v.detach().float().cpu() for k, v in sd.items()}
    if any(k.startswith(("feature_extractor.conv_layers.", "hubert.")) for k in sd):
        sd = _rename_hf(sd)
    sd.pop("masked_spec_embed", None)
    g = sd.pop("positional_embedding.conv.weight_g", None)
    v = sd.pop("positional_embedding.conv.weight_v", None)
    if g is not None and v is not None:
        norm = v.square().sum((0, 1), keepdim=True).sqrt().clamp(min=1e-12)
        sd["positional_embedding.conv.weight"] = v / norm * g
    sd.setdefault("proj.weight", torch.zeros(SOFT_DIM, HIDDEN))
    sd.setdefault("proj.bias", torch.zeros(SOFT_DIM))
    sd.setdefault("label_embedding.weight", torch.zeros(N_CLUSTERS, SOFT_DIM))
    return sd


def load_hubert_soft(path: str, device=None) -> HubertSoft:
    """A torch HuBERT-soft checkpoint (bshall or HF naming; a ``hubert`` or
    ``state_dict`` entry where the file nests it) as an eval-mode
    ``HubertSoft`` on ``device`` (default: the card)."""
    device = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict):
        ckpt = ckpt.get("hubert", ckpt.get("state_dict", ckpt))
    model = HubertSoft(device=device)
    model.load_state_dict(hubert_soft_weights(ckpt))
    return model.eval()


@torch.no_grad()
def encode_batch(model: HubertSoft, wav, bucket_samples: int = 16000, lengths=None):
    """wav (T,) or (B, T) -> (units (B, N, 256), log_probs (B, N, 100),
    n_frames (B,) valid unit counts), on the model's device.

    The sample axis is zero-padded to a ``bucket_samples`` multiple and the
    model runs masked, so each row's valid unit prefix matches its
    exact-length forward. Pass ``lengths`` (B,) when the rows are already
    tail-padded to a common length."""
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 1:
        wav = wav[None]
    if lengths is None:
        lengths = np.full((wav.shape[0],), wav.shape[1], np.int64)
    lengths = np.asarray(lengths, np.int64)
    if bucket_samples and wav.shape[1] % bucket_samples:
        wav = np.pad(wav, ((0, 0), (0, -wav.shape[1] % bucket_samples)))
    device = model.proj.weight.device
    lens = torch.from_numpy(lengths).to(device)
    units, log_probs = model(torch.from_numpy(wav).to(device), lens)
    return units, log_probs, conv_stack_frames(lens + 2 * UNITS_PAD)
