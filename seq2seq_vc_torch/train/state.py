"""Train state: the model, its optimizer and the update count (mirrors
seq2seq_vc_tpu/train/state.py, where the state is a functional pytree; here
the model and the optimizer change in place).

With a ``plan`` (``parallel/plan.py``: a model laid out over a mesh) the
clip takes the whole model's norm, ``state_dict`` is the single-process
layout gathered from every rank (a collective) and ``load_state_dict``
takes that layout and keeps this rank's part."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from ..parallel.plan import Plan
from .optim import Optimizer


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    plan: Optional[Plan] = None

    @property
    def steps(self) -> int:
        """Optimizer updates applied."""
        return self.optimizer.count

    def apply_gradients(self):
        """One update from the gradients that ``backward`` left in ``.grad``;
        returns the global norm before clipping (or None)."""
        if self.plan is None or not self.plan.model_parallel:
            return self.optimizer.step()
        names = [n for n, p in self.model.named_parameters() if p.requires_grad]
        return self.optimizer.step(lambda grads: self.plan.global_norm(names, grads))

    def state_dict(self) -> Dict[str, Any]:
        if self.plan is not None and self.plan.model_parallel:
            return self.plan.full_state(self.model, self.optimizer)
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: Dict[str, Any], load_only_params: bool = False) -> None:
        if self.plan is not None and self.plan.model_parallel:
            state = self.plan.local_state(self.model, state, load_only_params)
        self.model.load_state_dict(state["model"])
        if not load_only_params:
            self.optimizer.load_state_dict(state["optimizer"])
