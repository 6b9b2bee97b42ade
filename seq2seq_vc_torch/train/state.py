"""Train state: the model, its optimizer and the update count (mirrors
seq2seq_vc_tpu/train/state.py, where the state is a functional pytree; here
the model and the optimizer change in place)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from .optim import Optimizer


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer

    @property
    def steps(self) -> int:
        """Optimizer updates applied."""
        return self.optimizer.count

    def apply_gradients(self):
        """One update from the gradients that ``backward`` left in ``.grad``;
        returns the global norm before clipping (or None)."""
        return self.optimizer.step()

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: Dict[str, Any], load_only_params: bool = False) -> None:
        self.model.load_state_dict(state["model"])
        if not load_only_params:
            self.optimizer.load_state_dict(state["optimizer"])
