"""Pretrained-module transfer (mirrors seq2seq_vc_tpu/core/checkpoint.py:171-211,
``filter_modules`` and ``partial_transfer``), on port ``state_dict``s.

``init-mods`` names modules of the JAX package's parameter tree, not torch
prefixes: each torch key is resolved to its flax path (``convert.flax_paths``)
and a module is the top-level entry of that path, which the JAX functions
match. So for the VTN and Transformer-TTS, ``decoder`` is the decoder's
layers, ``after_norm`` and its positional encoding's alpha
(``decoder.embed.1.alpha``), while the prenet and its projection
(``decoder.embed.0.0``, ``decoder.embed.0.1``) are the top-level ``dprenet``
and ``dprenet_proj`` and are transferred only when named. A requested
module absent from the target, absent from the source, or whose tensors'
names or shapes differ between the two is skipped with a warning, as in the
JAX package. The source's keys are resolved with the target model's names:
the families that share modules (the VTN and Transformer-TTS) name them
alike.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

from ..convert import flax_paths


def _root(mod: str) -> str:
    return mod.split("/")[0].split(".")[0]


def module_keys(model: torch.nn.Module, keys=None) -> Dict[str, List[str]]:
    """{top-level flax module: its torch keys} of ``model``'s state_dict, or
    of ``keys`` laid out as the model's."""
    out: Dict[str, List[str]] = defaultdict(list)
    for key, path in flax_paths(model, keys).items():
        out[path.split("/")[0]].append(key)
    return dict(out)


def filter_modules(model: torch.nn.Module, init_mods: Sequence[str]) -> List[str]:
    """The requested modules whose top-level name is a module of ``model``."""
    top = set(module_keys(model))
    valid = []
    for mod in init_mods:
        if _root(mod) in top:
            valid.append(mod)
        else:
            logging.warning("module %s not found in target model; skipped", mod)
    return valid


def partial_transfer(model: torch.nn.Module, source: Mapping[str, torch.Tensor],
                     init_mods: Sequence[str]) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """``model``'s state_dict with the top-level modules of ``init_mods``
    copied from the ``source`` state_dict where their tensors' names and
    shapes match. Returns (the new state_dict, the modules transferred)."""
    target = model.state_dict()
    tgt, src = module_keys(model), module_keys(model, list(source))
    out = dict(target)
    transferred = []
    for mod in filter_modules(model, init_mods):
        root = _root(mod)
        if root not in src:
            logging.warning("module %s absent from source checkpoint; skipped", root)
            continue
        if ({k: tuple(target[k].shape) for k in tgt[root]}
                != {k: tuple(source[k].shape) for k in src[root]}):
            logging.warning("module %s shape mismatch; skipped", root)
            continue
        for k in tgt[root]:
            out[k] = source[k].to(dtype=target[k].dtype, device=target[k].device)
        transferred.append(root)
    logging.info("transferred modules: %s", transferred)
    return out, transferred


def init_from_checkpoint(model: torch.nn.Module, path: str,
                         init_mods: Sequence[str] = ()) -> List[str]:
    """Load a port checkpoint's weights into ``model`` (the training
    drivers' ``--init-checkpoint``): only the ``init_mods`` modules by
    ``partial_transfer`` when any are named, else the whole state_dict.
    Returns the modules transferred (every one without ``init_mods``)."""
    source = torch.load(path, map_location="cpu", weights_only=True)["model"]
    if not init_mods:
        model.load_state_dict(source)
        return sorted(module_keys(model))
    state, transferred = partial_transfer(model, source, init_mods)
    model.load_state_dict(state)
    return transferred
