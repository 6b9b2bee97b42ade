"""wav2vec2 for CTC in PyTorch, read from a local Hugging Face directory
without ``transformers`` (the model that seq2seq_vc_tpu/evaluate/asr.py
runs through ``transformers``' ``FlaxWav2Vec2ForCTC`` or ``Wav2Vec2ForCTC``).

The directory holds ``config.json``, ``vocab.json``,
``preprocessor_config.json``, optionally ``tokenizer_config.json`` and
``special_tokens_map.json``, and the weights as ``model.safetensors`` (read
by ``load_safetensors``: an 8-byte length, a JSON header, raw
little-endian tensors) or ``pytorch_model.bin`` (``torch.load(...,
weights_only=True)``); the safetensors file is preferred where both are
there, as ``transformers`` prefers it.

Both architectures: ``feat_extract_norm: group`` (a group norm of one
group a channel after the first conv) with post-LN encoder layers (the
base models) and ``layer`` (a layer norm after every conv) with
``do_stable_layer_norm`` pre-LN layers and a final norm (the large lv60
models). The modules keep ``transformers``' parameter names
(``wav2vec2.feature_extractor.conv_layers.{i}.conv``, ...,
``lm_head``), so a checkpoint's state dict loads as it is, after the
positional conv's weight norm (``weight_g``/``weight_v`` or
``parametrizations.weight.original0``/``original1``) is folded by
urhythmic/hubert.py's ``fold_weight_norm``, as HuBERT's is, and
``masked_spec_embed`` (a training parameter) is dropped. The group norm
is HuBERT's masked instance norm.

The forward is masked: a tail-padded batch with its valid sample counts
gives each row's exact-length logits on its valid frames (the group
norm's statistics over the valid frames, padded frames zeroed before the
positional conv, padded keys out of the softmax). The attention is dense
float32.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..urhythmic.hubert import fold_weight_norm, masked_instance_norm, valid_mask

# safetensors dtype names <-> torch dtypes
_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        begin, end = meta["data_offsets"]
        dtype = _ST_DTYPES[meta["dtype"]]
        t = torch.frombuffer(data, dtype=dtype, count=(end - begin) // dtype.itemsize,
                             offset=begin) if end > begin else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(meta["shape"]).clone()
    return out


def save_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Write tensors as ``load_safetensors`` (and the ``safetensors``
    package) reads them."""
    names = {v: k for k, v in _ST_DTYPES.items()}
    header: Dict[str, Any] = {"__metadata__": {"format": "pt"}}
    blobs, offset = [], 0
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous()
        blob = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for blob in blobs:
            f.write(blob)


def _activation(name: str):
    if name != "gelu":
        raise ValueError(f"activation {name!r}: the wav2vec2 CTC models use 'gelu'")
    return F.gelu


class _ConvLayer(torch.nn.Module):
    def __init__(self, cin: int, cout: int, k: int, s: int, bias: bool, norm: Optional[str],
                 device=None):
        super().__init__()
        self.conv = torch.nn.Conv1d(cin, cout, k, s, bias=bias, device=device)
        self.kind = norm
        if norm == "layer":
            self.layer_norm = torch.nn.LayerNorm(cout, device=device)
        elif norm == "group":  # one group a channel: an instance norm
            self.layer_norm = torch.nn.GroupNorm(cout, cout, device=device)


class FeatureEncoder(torch.nn.Module):
    def __init__(self, cfg: Dict[str, Any], device=None):
        super().__init__()
        dims, norm = cfg["conv_dim"], cfg["feat_extract_norm"]
        if norm not in ("group", "layer"):
            raise ValueError(f"feat_extract_norm {norm!r} (group or layer)")
        self.kernels, self.strides = cfg["conv_kernel"], cfg["conv_stride"]
        self.act = _activation(cfg.get("feat_extract_activation", "gelu"))
        self.conv_layers = torch.nn.ModuleList(
            _ConvLayer(1 if i == 0 else dims[i - 1], dims[i], k, s, cfg.get("conv_bias", False),
                       norm if norm == "layer" or i == 0 else None, device)
            for i, (k, s) in enumerate(zip(self.kernels, self.strides)))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        """x (B, N) samples -> ((B, F, C) features, (B,) valid frames)."""
        h, n = x[:, None], lengths
        for layer, k, s in zip(self.conv_layers, self.kernels, self.strides):
            h = layer.conv(h)
            n = (n - k) // s + 1
            if layer.kind == "layer":
                h = layer.layer_norm(h.transpose(1, 2)).transpose(1, 2)
            elif layer.kind == "group":
                h = masked_instance_norm(h, n, layer.layer_norm)
            h = self.act(h)
        return h.transpose(1, 2), n


class FeatureProjection(torch.nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.layer_norm = torch.nn.LayerNorm(cfg["conv_dim"][-1], eps=cfg["layer_norm_eps"],
                                             device=device)
        self.projection = torch.nn.Linear(cfg["conv_dim"][-1], cfg["hidden_size"], device=device)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class PositionalConvEmbedding(torch.nn.Module):
    """The grouped conv (its weight norm folded), padded k // 2 a side, its
    last frame dropped for an even kernel, then the activation."""

    def __init__(self, cfg, device=None):
        super().__init__()
        k, d = cfg["num_conv_pos_embeddings"], cfg["hidden_size"]
        self.conv = torch.nn.Conv1d(d, d, k, padding=k // 2,
                                    groups=cfg["num_conv_pos_embedding_groups"], device=device)
        self.act = _activation(cfg.get("feat_extract_activation", "gelu"))

    def forward(self, x):
        pos = self.conv(x.transpose(1, 2))
        if self.conv.kernel_size[0] % 2 == 0:
            pos = pos[:, :, :-1]
        return self.act(pos).transpose(1, 2)


class Attention(torch.nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        d = cfg["hidden_size"]
        self.heads = cfg["num_attention_heads"]
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, torch.nn.Linear(d, d, device=device))

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        dk = D // self.heads
        q, k, v = (getattr(self, n)(x).reshape(B, T, self.heads, dk).transpose(1, 2)
                   for n in ("q_proj", "k_proj", "v_proj"))
        logits = (q @ k.transpose(-1, -2)) * dk ** -0.5
        logits = logits.masked_fill(~key_mask[:, None, None, :], torch.finfo(logits.dtype).min)
        o = logits.softmax(-1) @ v
        return self.out_proj(o.transpose(1, 2).reshape(B, T, D))


class FeedForward(torch.nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.intermediate_dense = torch.nn.Linear(cfg["hidden_size"], cfg["intermediate_size"],
                                                  device=device)
        self.output_dense = torch.nn.Linear(cfg["intermediate_size"], cfg["hidden_size"],
                                            device=device)
        self.act = _activation(cfg.get("hidden_act", "gelu"))

    def forward(self, x):
        return self.output_dense(self.act(self.intermediate_dense(x)))


class EncoderLayer(torch.nn.Module):
    """Post-LN (``stable`` False) or pre-LN (``do_stable_layer_norm``)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.stable = bool(cfg.get("do_stable_layer_norm", False))
        self.attention = Attention(cfg, device)
        self.layer_norm = torch.nn.LayerNorm(d, eps=eps, device=device)
        self.feed_forward = FeedForward(cfg, device)
        self.final_layer_norm = torch.nn.LayerNorm(d, eps=eps, device=device)

    def forward(self, x, key_mask):
        if self.stable:
            x = x + self.attention(self.layer_norm(x), key_mask)
            return x + self.feed_forward(self.final_layer_norm(x))
        x = self.layer_norm(x + self.attention(x, key_mask))
        return self.final_layer_norm(x + self.feed_forward(x))


class Encoder(torch.nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.stable = bool(cfg.get("do_stable_layer_norm", False))
        self.pos_conv_embed = PositionalConvEmbedding(cfg, device)
        self.layer_norm = torch.nn.LayerNorm(cfg["hidden_size"], eps=cfg["layer_norm_eps"],
                                             device=device)
        self.layers = torch.nn.ModuleList(EncoderLayer(cfg, device)
                                          for _ in range(cfg["num_hidden_layers"]))

    def forward(self, h, key_mask):
        h = h.masked_fill(~key_mask[..., None], 0.0)  # what the exact run's conv pads with
        h = h + self.pos_conv_embed(h)
        if not self.stable:
            h = self.layer_norm(h)
        for layer in self.layers:
            h = layer(h, key_mask)
        return self.layer_norm(h) if self.stable else h


class Wav2Vec2Model(torch.nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.feature_extractor = FeatureEncoder(cfg, device)
        self.feature_projection = FeatureProjection(cfg, device)
        self.encoder = Encoder(cfg, device)

    def forward(self, x, lengths):
        feats, n = self.feature_extractor(x, lengths)
        h = self.feature_projection(feats)
        return self.encoder(h, valid_mask(n, h.shape[1])), n


class Wav2Vec2ForCTC(torch.nn.Module):
    """``config`` is a ``config.json`` dict (``transformers``' field names)."""

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__()
        cfg = dict(config)
        if cfg.get("add_adapter"):
            raise ValueError("add_adapter: the wav2vec2 CTC models have no adapter")
        cfg.setdefault("layer_norm_eps", 1e-5)
        cfg.setdefault("conv_bias", False)
        self.config = cfg
        self.wav2vec2 = Wav2Vec2Model(cfg, device)
        self.lm_head = torch.nn.Linear(cfg["hidden_size"], cfg["vocab_size"], device=device)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None):
        """x (B, N) normalised samples, ``lengths`` (B,) valid samples of a
        tail-padded batch (default: all) -> (logits (B, F, vocab) float32,
        (B,) valid frames)."""
        if lengths is None:
            lengths = torch.full((x.shape[0],), x.shape[1], device=x.device)
        h, n = self.wav2vec2(x, lengths)
        return self.lm_head(h), n


def wav2vec2_weights(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A checkpoint's state dict -> this module's: float32, the positional
    conv's weight norm folded, ``masked_spec_embed`` dropped."""
    sd = {k: v.float() if v.is_floating_point() else v for k, v in sd.items()}
    sd.pop("wav2vec2.masked_spec_embed", None)
    fold_weight_norm(sd, "wav2vec2.encoder.pos_conv_embed.conv")
    return sd


def _token(value, default: str) -> str:
    """A special token as ``tokenizer_config.json`` stores it (a string or
    an added-token dict)."""
    if value is None:
        return default
    return value["content"] if isinstance(value, dict) else value


class Processor:
    """The wav2vec2 feature extractor and CTC tokenizer of a model
    directory: per-utterance zero-mean, unit-variance normalisation (the
    variance plus 1e-7) where ``do_normalize``, and greedy CTC decoding
    (repeats collapsed, the pad token dropped, the word delimiter a space,
    stripped; lower-cased with ``do_lower_case``; ``transformers``'
    clean-up of spaces before punctuation with
    ``clean_up_tokenization_spaces``, off by default as in its 4.x line)."""

    def __init__(self, model_dir: str):
        def read(name, default=None):
            path = os.path.join(model_dir, name)
            if not os.path.exists(path):
                if default is None:
                    raise FileNotFoundError(path)
                return default
            with open(path) as f:
                return json.load(f)

        fe = read("preprocessor_config.json")
        self.sampling_rate = int(fe.get("sampling_rate", 16000))
        self.do_normalize = bool(fe.get("do_normalize", True))
        self.vocab: Dict[str, int] = read("vocab.json")
        tok = dict(read("special_tokens_map.json", {}), **read("tokenizer_config.json", {}))
        self.pad_token = _token(tok.get("pad_token"), "<pad>")
        self.unk_token = _token(tok.get("unk_token"), "<unk>")
        self.word_delimiter_token = _token(tok.get("word_delimiter_token"), "|")
        self.do_lower_case = bool(tok.get("do_lower_case", False))
        self.clean_up = bool(tok.get("clean_up_tokenization_spaces", False))
        self.id_to_token = {i: t for t, i in self.vocab.items()}

    def normalize(self, audio, sr: int) -> np.ndarray:
        if sr != self.sampling_rate:
            raise ValueError(f"the model was trained at {self.sampling_rate} Hz, got {sr} Hz")
        x = np.asarray(audio, np.float32)
        if self.do_normalize:
            x = (x - x.mean()) / np.sqrt(x.var() + 1e-7)
        return x

    def decode(self, ids) -> str:
        tokens = [self.id_to_token.get(int(i), self.unk_token) for i in ids]
        chars: List[str] = []
        for t in tokens:
            if not chars or chars[-1] != t:
                chars.append(t)
        chars = [" " if c == self.word_delimiter_token else c for c in chars
                 if c != self.pad_token]
        text = "".join(chars).strip()
        if self.do_lower_case:
            text = text.lower()
        if self.clean_up:
            for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                         (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                         (" 're", "'re")):
                text = text.replace(a, b)
        return text


def load_wav2vec2(model_dir: str, device=None) -> Wav2Vec2ForCTC:
    """The eval-mode float32 ``Wav2Vec2ForCTC`` of a local directory on
    ``device`` (default: the card)."""
    device = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        config = json.load(f)
    st = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st):
        sd = load_safetensors(st)
    else:
        sd = torch.load(os.path.join(model_dir, "pytorch_model.bin"), map_location="cpu",
                        weights_only=True)
    model = Wav2Vec2ForCTC(config, device="meta")
    model.load_state_dict(wav2vec2_weights(sd), assign=True)
    return model.to(device).eval()


