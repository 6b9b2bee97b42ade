"""The ``ppg_sxliu`` extractor: wav -> phonetic-posteriorgram features
(mirrors seq2seq_vc_tpu/encoders/ppg.py).

- ``LogMelFbank``: the upstream's front end, a 25 ms / 10 ms log-mel
  fbank at 16 kHz (a symmetric ``np.hanning(400)`` zero-padded on the
  right to 512, natural log floored at 1e-10).
- ``PPGUpstream``: an espnet conformer ASR encoder (the port's
  ``ConformerEncoder`` with the conv2d input layer, new-style relative
  positions and the batch-norm conv module) returning the embed output and
  each block's output, the last one through ``after_norm``.
- ``Featurizer``: s3prl's softmax-weighted sum of those states, its
  weights from an s3prl-vc downstream checkpoint.

The upstream's espnet names (``encoder.embed.conv.0``,
``encoder.encoders.N.conv_module.norm.running_mean``, ...) are the port
module's own, so a checkpoint loads by name. Its hyperparameters are read
from the checkpoint's shapes (``infer_architecture``). Checkpoints are read
with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..dsp.features import _logmel
from ..dsp.mel import mel_filterbank
from ..dsp.stft import reflect_pad
from ..nn.conformer import ConformerEncoder


class LogMelFbank:
    """The upstream's front end (JAX ``log_mel_fbank``): (N,) float32
    samples -> (1 + N // frame_shift, n_mels) log-mel fbank through
    ``dsp/features._logmel``. Reflect padding by fft_size // 2 each side,
    the window ``np.hanning(frame_length)`` padded with zeros on the right,
    the Slaney mel basis, natural log. The window and the basis are made
    once and stay on ``device``."""

    def __init__(self, sample_rate: int = 16000, n_mels: int = 80, device=None,
                 frame_length: int = 400, frame_shift: int = 160, fft_size: int = 512):
        self.fft_size, self.frame_shift = fft_size, frame_shift
        win = np.pad(np.hanning(frame_length), (0, fft_size - frame_length)).astype(np.float32)
        fb_t = mel_filterbank(sample_rate, fft_size, n_mels, 0.0, sample_rate / 2).T
        self.window = torch.as_tensor(win, device=device)
        self.mel_basis_t = torch.as_tensor(fb_t, device=device)

    def __call__(self, wav: torch.Tensor) -> torch.Tensor:
        pad = self.fft_size // 2
        return _logmel(reflect_pad(wav, pad, pad), self.window, self.mel_basis_t,
                       self.fft_size, self.frame_shift, log_base=None)


class PPGUpstream(torch.nn.Module):
    """Conformer ASR encoder over fbank features; ``forward`` returns every
    layer's state, ``[embed_out, block_1, ..., block_N]``, each (B, T', adim)
    with T' the conv2d input layer's x4 subsampling of the fbank frames."""

    def __init__(self, input_dim: int = 80, adim: int = 256, aheads: int = 4,
                 eunits: int = 2048, elayers: int = 12, input_layer: str = "conv2d",
                 macaron_style: bool = True, use_cnn_module: bool = True,
                 cnn_module_kernel: int = 15, positionwise_layer_type: str = "linear",
                 device=None):
        super().__init__()
        self.input_dim = input_dim
        self.encoder = ConformerEncoder(
            idim=input_dim, attention_dim=adim, attention_heads=aheads, linear_units=eunits,
            num_blocks=elayers, dropout_rate=0.0, positional_dropout_rate=0.0,
            attention_dropout_rate=0.0, input_layer=input_layer, macaron_style=macaron_style,
            pos_enc_layer_type="rel_pos", selfattention_layer_type="rel_selfattn",
            use_cnn_module=use_cnn_module, cnn_module_kernel=cnn_module_kernel,
            positionwise_layer_type=positionwise_layer_type, conv_norm_type="batch_norm",
            attention_backend="xla", device=device,
        )

    def forward(self, feats: torch.Tensor, masks: Optional[torch.Tensor] = None
                ) -> List[torch.Tensor]:
        enc = self.encoder
        xs = feats
        if enc.input_layer == "conv2d":
            xs, masks = enc.embed(xs, masks)
        else:
            xs = enc.embed(xs)
        xs, pos_emb = enc.pos_enc(xs)
        attn_mask = None if masks is None else masks[:, None, :]
        states = [xs]
        for layer in enc.encoders:
            xs = layer(xs, attn_mask, pos_emb)
            states.append(xs)
        if enc.normalize_before:
            states[-1] = enc.after_norm(states[-1])
        return states


class Featurizer:
    """s3prl's ``Featurizer``: the state stack collapsed by softmax layer
    weights (``['featurizer']['weights']`` of an s3prl-vc checkpoint)."""

    def __init__(self, weights: np.ndarray):
        self.weights = np.asarray(weights, np.float32)

    def __call__(self, states: List[torch.Tensor]) -> torch.Tensor:
        n = len(states)
        if self.weights.shape[0] != n:
            raise ValueError(
                f"featurizer has {self.weights.shape[0]} layer weights but the "
                f"upstream produced {n} states: upstream architecture mismatch"
            )
        w = torch.softmax(torch.as_tensor(self.weights, device=states[0].device), dim=0)
        out = 0
        for wi, s in zip(w, states):  # in order, as the JAX sum
            out = out + wi * s
        return out


def _strip_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Keys rooted at ``encoder.`` (a ``model.``, ``e2e.`` or ``ppg_model.``
    prefix stripped; the ASR model's other heads dropped)."""
    for prefix in ("model.", "e2e.", "ppg_model."):
        if all(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()}
    if not any(k.startswith("encoder.") for k in sd):
        raise KeyError(
            "no 'encoder.*' keys in the upstream state_dict: not an "
            f"espnet-style PPG model (keys: {sorted(sd)[:8]}...)"
        )
    return {k: v for k, v in sd.items() if k.startswith("encoder.")}


def infer_architecture(sd: Dict[str, Any]) -> Dict[str, Any]:
    """The conformer's hyperparameters read from an espnet state_dict's
    names and shapes. With the conv2d input layer ``input_dim`` is the
    smallest width the post-conv Linear allows, 4 * f2 + 3 (79 for an
    80-bin fbank): pass the real one to ``load_ppg_upstream``."""
    n_blocks = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.encoders."))
    first = "encoder.encoders.0."
    adim = int(sd[first + "norm_mha.weight"].shape[0])
    w1 = sd[first + "feed_forward.w_1.weight"]
    use_cnn = (first + "conv_module.pointwise_conv1.weight") in sd
    kernel = int(sd[first + "conv_module.depthwise_conv.weight"].shape[-1]) if use_cnn else 31
    if "encoder.embed.conv.0.weight" in sd:
        input_layer = "conv2d"
        f2 = int(sd["encoder.embed.out.0.weight"].shape[1]) // adim
        input_dim = f2 * 4 + 3
    else:
        input_layer = "linear"
        input_dim = int(sd["encoder.embed.0.weight"].shape[1])
    pb = sd.get(first + "self_attn.pos_bias_u")
    return dict(
        input_dim=input_dim, adim=adim, aheads=int(pb.shape[0]) if pb is not None else 4,
        eunits=int(w1.shape[0]), elayers=n_blocks, input_layer=input_layer,
        macaron_style=(first + "feed_forward_macaron.w_1.weight") in sd,
        use_cnn_module=use_cnn, cnn_module_kernel=kernel,
        positionwise_layer_type="conv1d" if w1.ndim == 3 else "linear",
    )


def _load(checkpoint: str):
    return torch.load(checkpoint, map_location="cpu", weights_only=True)


def load_ppg_upstream(checkpoint: str, input_dim: Optional[int] = None,
                      device=None) -> PPGUpstream:
    """The upstream built from a torch checkpoint (a state_dict, or one
    under ``model`` or ``state_dict``) and loaded by name, in ``eval()``
    mode on ``device`` (default: the card). ``input_dim`` sets the fbank
    width where the conv2d input layer leaves it open."""
    device = resolve_device(device)
    sd = _load(checkpoint)
    for key in ("model", "state_dict"):
        if isinstance(sd, dict) and key in sd:
            sd = sd[key]
    sd = _strip_prefix(dict(sd))
    arch = infer_architecture(sd)
    if input_dim is not None:
        arch["input_dim"] = input_dim
    model = PPGUpstream(**arch)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"upstream checkpoint does not match the conformer {arch}: missing "
                       f"{missing[:8]}, unexpected {unexpected[:8]}")
    return model.to(device).eval()


def load_featurizer(checkpoint: str) -> Featurizer:
    """Featurizer weights from an s3prl-vc downstream checkpoint
    (``['featurizer']['weights']``) or a bare featurizer state_dict."""
    obj = _load(checkpoint)
    if isinstance(obj, dict) and "featurizer" in obj:
        obj = obj["featurizer"]
    if not (isinstance(obj, dict) and "weights" in obj):
        raise KeyError("no featurizer weights found in checkpoint (expected "
                       "['featurizer']['weights'] as saved by s3prl-vc)")
    return Featurizer(torch.as_tensor(obj["weights"]).float().numpy())


def build_extractor(upstream_ckpt: str, featurizer_ckpt: str, sample_rate: int = 16000,
                    input_dim: Optional[int] = None,
                    device=None) -> Callable[[np.ndarray], np.ndarray]:
    """wav (numpy, 16 kHz) -> PPG features (numpy float32), the upstream's
    states collapsed by the trained featurizer, on ``device`` (default: the
    card). Each utterance runs at its exact length, as the JAX extractor's
    ``jit`` does (padding the wav would change the fbank's last frames)."""
    model = load_ppg_upstream(upstream_ckpt, input_dim, device)
    featurizer = load_featurizer(featurizer_ckpt)
    dev = next(model.parameters()).device
    fbank = LogMelFbank(sample_rate, model.input_dim, dev)

    @torch.no_grad()
    def extract(wav: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(wav, np.float32), device=dev)
        feats = fbank(x)
        states = model(feats[None])
        return featurizer([s[0] for s in states]).float().cpu().numpy()

    return extract
