"""Optimizer: Adam, AdamW or SGD on the warmup schedule, clip by global
norm, gradient accumulation (mirrors seq2seq_vc_tpu/train/optim.py, an
optax chain there).

``Optimizer.step`` is one optax update of ``chain(clip_by_global_norm,
adam(schedule))`` (or ``adamw``, ``sgd``) under ``MultiSteps``:

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
``optax.adamw`` adds ``weight_decay`` (optax's default 1e-4) times the
parameter to the Adam direction and scales the sum by the learning rate:
``torch.optim.AdamW``'s decay of ``p`` by ``lr * weight_decay`` before its
Adam step, from the same ``p``. ``optax.sgd`` with ``momentum`` (None by
default: plain SGD) keeps a trace ``m = g + momentum * m`` from zero and
steps along it, or along ``g + momentum * m`` with ``nesterov``:
``torch.optim.SGD``'s buffer, which starts at the first gradient, and its
Nesterov step, with no dampening.

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


def _torch_optimizer(name: str, params, lr: float, kw: Dict[str, Any]):
    """The torch optimizer of ``optimizer_type`` ``name`` with optax's
    ``optimizer_params`` names and defaults."""
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(kw.pop("b1", 0.9), kw.pop("b2", 0.999)),
                                eps=kw.pop("eps", 1e-8))
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(kw.pop("b1", 0.9), kw.pop("b2", 0.999)),
                                 eps=kw.pop("eps", 1e-8),
                                 weight_decay=kw.pop("weight_decay", 1e-4))
    if name == "sgd":
        momentum, nesterov = kw.pop("momentum", None), kw.pop("nesterov", False)
        if momentum is None:  # optax: no trace, so no Nesterov step either
            return torch.optim.SGD(params, lr=lr)
        return torch.optim.SGD(params, lr=lr, momentum=momentum, nesterov=nesterov)
    raise ValueError(f"unknown optimizer_type: {name}")


class Optimizer:
    def __init__(self, params: Iterable[torch.nn.Parameter], schedule, grad_norm=None,
                 gradient_accumulate_steps: int = 1, optimizer_type: str = "Adam",
                 **optimizer_params):
        self.params: List[torch.nn.Parameter] = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.grad_norm = grad_norm if grad_norm and grad_norm > 0 else None
        self.accumulate = int(gradient_accumulate_steps or 1)
        self.count = 0  # optimizer updates applied
        kw = dict(optimizer_params)
        self.opt = _torch_optimizer(optimizer_type.lower(), self.params, schedule(0), kw)
        if kw:
            raise TypeError(f"{optimizer_type}: unexpected optimizer_params {sorted(kw)}")

    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.schedule(self.count)

    @torch.no_grad()
    def step(self, norm_fn=None) -> Optional[torch.Tensor]:
        """Apply one update from the accumulated gradients and zero them.
        Returns the global norm before clipping (a 0-dim tensor on the
        parameters' device), or None without clipping. ``norm_fn(grads)``
        takes the norm in place of this rank's own (a model split over
        ranks: ``parallel/plan.py``)."""
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
            ) if norm_fn is None else norm_fn(grads)
            scale = self.grad_norm / torch.clamp(norm, min=self.grad_norm)
            torch._foreach_mul_(grads, scale)
        for group in self.opt.param_groups:
            group["lr"] = self.lr()
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.count += 1
        return norm

    def state_dict(self) -> Dict[str, Any]:
        return {"adam": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.opt.load_state_dict(state["adam"])
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
    optimizer_params = dict(optimizer_params or {})
    lr = optimizer_params.pop("lr", 1e-3)
    schedule = get_scheduler(scheduler, lr, **(scheduler_params or {}))
    return Optimizer(params, schedule, grad_norm, gradient_accumulate_steps, optimizer_type,
                     **optimizer_params)
