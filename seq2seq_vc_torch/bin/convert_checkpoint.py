"""Convert a reference (torch) checkpoint into a port checkpoint (mirrors
seq2seq_vc_tpu/bin/convert_checkpoint.py).

    python -m seq2seq_vc_torch.bin.convert_checkpoint \\
        --torch-checkpoint checkpoint-50000steps.pkl \\
        --config exp/.../config.yml \\
        --outpath exp/.../checkpoint-50000steps.pt

The reference publishes pretrained VTN / AAS-VC / FastSpeechVC /
TransformerTTS checkpoints as ``torch.save`` dicts (``{"model":
state_dict, "steps": N, "epochs": E, ...}``) or bare state dicts. The
port's modules carry the reference's parameter names, so the state dict
loads into the model of the config's ``model_type`` and ``model_params``
by name, strictly: every tensor of the model must be in the checkpoint and
every tensor of the checkpoint must be consumed. Names are mapped only
where the JAX converter maps them (``seq2seq_vc_tpu/convert/reference.py``):
BatchNorm ``num_batches_tracked`` counters are dropped (the model's own
stay 0), and the duration-predictor projection's output Linear is read as
``out`` or ``out.0``. The output is the port's checkpoint, ``{"model":
state_dict, "steps", "epochs"}``, which ``vc_decode``, ``vc_serve`` and
``vc_train --init-checkpoint`` read.

Checkpoints whose BatchNorm running statistics the config's model cannot
hold raise with the JAX converter's instruction: set ``postnet_norm_type:
batch_norm`` (and for conformers ``conformer_conv_norm_type:
batch_norm``) in the model_params. Such a model decodes and serves; the
trainers refuse it, as the JAX package's do.

The reference pickle holds more than tensors (its ``config`` and optimizer
state), so it is read with ``torch.load(weights_only=False)``: convert
only checkpoints from a source you trust. The conversion runs on the CPU
and touches no device.
"""

from __future__ import annotations

import argparse
import logging
from typing import Any, Dict

import torch

from ..core.config import load_config
from ..models import get_model_class
from . import setup

MODEL_TYPES = ("VTN", "AASVC", "FastSpeechVC", "TransformerTTS")
# the JAX converter's instructions for BatchNorm statistics that the
# model's norm cannot hold
_NEED_BATCH_NORM = {
    "conv_module": "checkpoint contains conformer BatchNorm running stats; set "
                   "conformer_conv_norm_type='batch_norm' on the model (the TPU-default "
                   "GroupNorm cannot represent them)",
    "postnet": "checkpoint contains postnet BatchNorm running stats; set "
               "postnet_norm_type='batch_norm' on the model",
}


def reference_state_dict(obj: Any):
    """(state_dict, steps, epochs) of a loaded reference checkpoint: a
    ``{"model": state_dict, ...}`` dict or a bare state dict."""
    if isinstance(obj, dict) and "model" in obj:
        return obj["model"], int(obj.get("steps", 0)), int(obj.get("epochs", 0))
    return obj, 0, 0


def load_reference(model: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Load a reference state dict into the port ``model`` by name,
    strictly, with the JAX converter's mappings only."""
    from ..nn.conformer import ConvBatchNorm

    modules = dict(model.named_modules())
    sd = {}
    for key, value in state.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key.startswith("duration_predictor_projection.out.0."):
            key = key.replace(".out.0.", ".out.", 1)
        if key.endswith(".running_mean"):
            mod = modules.get(key.rpartition(".")[0])
            if not isinstance(mod, ConvBatchNorm):
                where = "conv_module" if ".conv_module." in key else "postnet"
                raise ValueError(_NEED_BATCH_NORM[where])
        sd[key] = torch.as_tensor(value)
    own = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    missing, unconsumed = sorted(own - set(sd)), sorted(set(sd) - own)
    if missing or unconsumed:
        raise ValueError("reference checkpoint does not match the config's model: missing "
                         f"{missing[:10]}, unconverted torch tensors {unconsumed[:10]}")
    model.load_state_dict(sd, strict=False)


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(
        description="Convert a reference torch checkpoint into a port checkpoint")
    parser.add_argument("--torch-checkpoint", required=True)
    parser.add_argument("--config", required=True,
                        help="reference exp config.yml (model_type/model_params)")
    parser.add_argument("--outpath", required=True)
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup(args.verbose)

    config = load_config(args.config)
    model_type = config["model_type"]
    if model_type not in MODEL_TYPES:
        raise NotImplementedError(f"model_type {model_type!r}: converters exist for "
                                  f"{sorted(MODEL_TYPES)}")
    obj = torch.load(args.torch_checkpoint, map_location="cpu", weights_only=False)
    state, steps, epochs = reference_state_dict(obj)
    model = get_model_class(model_type)(**config["model_params"], device="cpu")
    load_reference(model, state)
    n = sum(p.numel() for p in model.parameters())
    logging.info("converted %s: %.2fM params -> %s (steps=%d)", model_type, n / 1e6,
                 args.outpath, steps)
    torch.save({"model": model.state_dict(), "steps": steps, "epochs": epochs}, args.outpath)
    return args.outpath


if __name__ == "__main__":
    main()
