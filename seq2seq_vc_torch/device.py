"""The port's device rule: an entry point runs on the card unless its
caller names another device, and never falls back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The card for ``None``, else the device named; raises for ``None``
    when there is no card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU explicitly"
            )
        device = "cuda"
    return torch.device(device)
