"""What the waveform generators share: the torch-checkpoint reader, the
``generator_params`` reader and a convolution in the compute dtype.

The checkpoint reader reads what the JAX package's loaders read
(seq2seq_vc_tpu/vocoder/melgan.py:357 ``_torch_generator_sd``, the
``model`` then ``generator`` nesting of a ``parallel_wavegan`` ``.pkl``,
the ``module.`` prefix of ``torch_pwg_to_flax``) and folds weight norm
(``weight_g``, ``weight_v``) into a plain ``weight``, as
seq2seq_vc_tpu/vocoder/convert_torch.py:20-29 ``_effective_weight`` does.
It loads with ``weights_only=True``: a file that holds objects other than
tensors, containers and numbers is refused with torch's message naming
them.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch
import torch.nn.functional as F

from ..core.config import load_config

def fold_weight_norm(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``<p>.weight_g`` and ``<p>.weight_v`` -> ``<p>.weight`` = v * g / |v|,
    the norm taken over the axes where g has size 1 (axis 0 kept, torch's
    default); other entries unchanged."""
    out = {}
    for key, value in state.items():
        if key.endswith(".weight_g"):
            continue
        if key.endswith(".weight_v"):
            prefix = key[: -len(".weight_v")]
            v = value.double()
            g = state[f"{prefix}.weight_g"].double()
            dims = [d for d in range(v.ndim) if g.ndim < v.ndim or g.shape[d] == 1]
            norm = torch.linalg.vector_norm(v, dim=dims, keepdim=True)
            out[f"{prefix}.weight"] = (v * (g / norm)).float()
        else:
            out[key] = value
    return out


def read_generator_state(checkpoint: str) -> Dict[str, torch.Tensor]:
    """A generator's state dict from a torch checkpoint: the ``model`` and
    then the ``generator`` entry where the file nests them, ``module.``
    stripped, weight norm folded; on the CPU."""
    state = torch.load(checkpoint, map_location="cpu", weights_only=True)
    for key in ("model", "generator"):
        if isinstance(state, dict) and key in state:
            state = state[key]
    return fold_weight_norm({k.removeprefix("module."): v for k, v in state.items()})


def generator_params(config_path: Optional[str], keys: Iterable[str]) -> Dict[str, Any]:
    """The ``keys`` that a ``parallel_wavegan`` config's ``generator_params``
    sets (scale lists as tuples); {} without a config."""
    if not config_path:
        return {}
    params = load_config(config_path).get("generator_params") or {}
    out = {k: params[k] for k in keys if k in params}
    for key in ("upsample_scales", "noise_upsample_scales"):
        if key in out:
            out[key] = tuple(out[key])
    return out


def layer_weight(layer: torch.nn.Module) -> torch.Tensor:
    """``layer``'s weight; under flax's weight norm (``weight_g`` and
    ``weight_v``, ``hifigan.weight_norm_``) ``weight_v * rsqrt(sum(weight_v^2)
    + 1e-12) * weight_g``, the sum over the axes where ``weight_g`` has size
    1, in float32."""
    if "weight_v" not in layer._parameters:
        return layer.weight
    v, g = layer.weight_v, layer.weight_g
    dims = [d for d in range(v.ndim) if g.shape[d] == 1]
    return v * torch.rsqrt(v.square().sum(dims, keepdim=True) + 1e-12) * g


def conv(layer: torch.nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` (a Conv1d, Conv2d or ConvTranspose1d holding float32
    weights, weight-normed or not) applied to ``x`` in ``dtype``."""
    w = layer_weight(layer).to(dtype)
    b = None if layer.bias is None else layer.bias.to(dtype)
    if isinstance(layer, torch.nn.ConvTranspose1d):
        return F.conv_transpose1d(x.to(dtype), w, b, layer.stride, layer.padding,
                                  layer.output_padding, layer.groups, layer.dilation)
    return layer._conv_forward(x.to(dtype), w, b)
