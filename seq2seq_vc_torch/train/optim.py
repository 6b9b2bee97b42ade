"""Optimizer: Adam on the warmup schedule, clip by global norm, gradient
accumulation (mirrors seq2seq_vc_tpu/train/optim.py, an optax chain there).

``Optimizer.step`` is one optax update of ``chain(clip_by_global_norm,
adam(schedule))`` under ``MultiSteps``:

- accumulation: ``backward`` sums the micro-batch gradients into ``.grad``;
  the step divides them by the count, as MultiSteps averages them;
- clipping as ``optax.clip_by_global_norm``: the gradients are scaled by
  ``max_norm / max(norm, max_norm)``. ``torch.nn.utils.clip_grad_norm_``
  scales by ``max_norm / (norm + 1e-6)`` whenever that is below 1, so it
  also shrinks gradients whose norm is just under the limit;
- a parameter that the loss did not reach gets a zero gradient, as optax
  sees zeros: its Adam moments decay and every parameter shares one step
  count, which is what the bias correction reads;
- the learning rate of update ``n`` (0 for the first) is ``schedule(n)``,
  the optax ``count`` indexing (``schedulers.py``).

Adam's arithmetic is ``torch.optim.Adam``'s, the same formula as
``optax.adam`` (``b1``, ``b2``, ``eps`` under the optax names).

``freeze_mods`` (JAX: ``optax.multi_transform`` routing the frozen subtrees
to ``set_to_zero``): a parameter whose flax path (``convert.flax_paths``,
``params/`` in front) starts with a listed prefix, or with ``params/`` and
the prefix, as ``_freeze_mask_fn`` matches it, gets ``requires_grad`` off.
It then gets no gradient, no update and no Adam state, and the clip's
global norm reads only the trainable parameters, as the transform that
``multi_transform`` gives the trainable ones sees only theirs. Gradients
still flow through a frozen module to the modules before it.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import torch

from .schedulers import get_scheduler


def frozen_names(model: torch.nn.Module, freeze_mods: Sequence[str]) -> List[str]:
    """The parameters of ``model`` that ``freeze_mods`` freezes."""
    from ..convert import flax_paths

    paths = flax_paths(model)
    out = []
    for name, _ in model.named_parameters():
        joined = "params/" + paths[name]
        if any(joined.startswith(m) or joined.startswith(f"params/{m}") for m in freeze_mods):
            out.append(name)
    return out


class Optimizer:
    def __init__(self, params: Iterable[torch.nn.Parameter], schedule, grad_norm=None,
                 gradient_accumulate_steps: int = 1, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params: List[torch.nn.Parameter] = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.grad_norm = grad_norm if grad_norm and grad_norm > 0 else None
        self.accumulate = int(gradient_accumulate_steps or 1)
        self.count = 0  # optimizer updates applied
        self.adam = torch.optim.Adam(self.params, lr=schedule(0), betas=(b1, b2), eps=eps)

    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.schedule(self.count)

    @torch.no_grad()
    def step(self) -> Optional[torch.Tensor]:
        """Apply one update from the accumulated gradients and zero them.
        Returns the global norm before clipping (a 0-dim tensor on the
        parameters' device), or None without clipping."""
        grads = []
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if self.accumulate > 1:
            torch._foreach_div_(grads, float(self.accumulate))
        norm = None
        if self.grad_norm is not None:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)).float()
            )
            scale = self.grad_norm / torch.clamp(norm, min=self.grad_norm)
            torch._foreach_mul_(grads, scale)
        for group in self.adam.param_groups:
            group["lr"] = self.lr()
        self.adam.step()
        self.adam.zero_grad(set_to_none=True)
        self.count += 1
        return norm

    def state_dict(self) -> Dict[str, Any]:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


def build_optimizer(
    params: Union[torch.nn.Module, Iterable[torch.nn.Parameter]],
    optimizer_type: str = "Adam",
    optimizer_params: Optional[Dict[str, Any]] = None,
    scheduler: str = "warmuplr",
    scheduler_params: Optional[Dict[str, Any]] = None,
    grad_norm: Optional[float] = None,
    gradient_accumulate_steps: int = 1,
    freeze_mods: Optional[List[str]] = None,
) -> Optimizer:
    """The optimizer of a training config's ``optimizer_*``, ``scheduler*``,
    ``grad_norm``, ``gradient_accumulate_steps`` and ``freeze_mods`` keys,
    over ``params``: a model's parameters, or the model itself (needed for
    ``freeze_mods``, which turns ``requires_grad`` off on the frozen
    parameters)."""
    if freeze_mods:
        if not isinstance(params, torch.nn.Module):
            raise ValueError("freeze_mods needs the model, not its parameters")
        for name in frozen_names(params, freeze_mods):
            params.get_parameter(name).requires_grad_(False)
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    if optimizer_type.lower() != "adam":
        raise NotImplementedError(f"optimizer_type {optimizer_type!r} is not ported yet")
    optimizer_params = dict(optimizer_params or {})
    lr = optimizer_params.pop("lr", 1e-3)
    schedule = get_scheduler(scheduler, lr, **(scheduler_params or {}))
    return Optimizer(params, schedule, grad_norm, gradient_accumulate_steps, **optimizer_params)
