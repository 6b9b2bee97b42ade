"""Pipeline parallelism: GPipe over the mesh's ``pipe`` group (mirrors
seq2seq_vc_tpu/parallel/pp.py).

Stage ``s`` of ``n`` holds ``n_layers / n`` consecutive layers. The batch
splits into ``n_micro`` microbatches that march through the stages in
``n_micro + n - 1`` ticks: each tick every stage applies its layers to the
activation it holds and hands the result to the next stage
(``collectives.shift``, whose backward hands the gradients back), stage 0
taking microbatch ``t`` in; the last stage records microbatch ``t - (n -
1)``. As in the JAX program, every stage computes in every tick: in the
bubble ticks (warm-up and drain) it runs real data whose result is never
recorded (stage 0 re-reads the last microbatch, the others hold what they
were handed), never zeros, so a layer whose derivative is not finite at
degenerate inputs cannot put NaN into the gradients. Each stage knows the
microbatch it holds at each tick and takes that microbatch's mask (the
JAX program carries the masks round the ring with the activations).

Every stage issues the same collectives in the same order, forward and
backward: the stage input and the recorded outputs take part in each
rank's graph through ``torch.where`` and a 0/1 factor, never through a
branch that leaves a shift out. The recorded outputs are summed over the
group (each stage but the last contributes zeros), so every rank holds the
stack's output, as the JAX program's masked ``psum`` gives it. That sum's
backward is the identity (every rank's loss is the same replicated
function of it) and the stack input's is a sum over the stages (stage 0
alone holds its gradient), so the computation around the stack sees whole
gradients on every rank and a stage's layers get theirs from its own
ticks alone.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from . import collectives


def stack_layer_params(layer_params: List[Any]) -> Any:
    """Stack per-layer parameters (tensors, or dicts of tensors of the same
    shapes) along a new leading layer axis."""
    if isinstance(layer_params[0], dict):
        return {k: torch.stack([p[k] for p in layer_params]) for k in layer_params[0]}
    return torch.stack(layer_params)


def _layer(params: Any, j: int) -> Any:
    if isinstance(params, dict):
        return {k: v[j] for k, v in params.items()}
    return params[j]


def _gpipe(stage_fn: Callable[[torch.Tensor, int], torch.Tensor], xs: torch.Tensor,
           group) -> torch.Tensor:
    """Run ``(n_micro, micro_batch, ...)`` microbatches through the stages;
    ``stage_fn(h, mb)`` applies this stage's layers to microbatch ``mb``'s
    activation. Returns the last stage's outputs on every rank."""
    n, s = collectives.size(group), collectives.rank(group)
    n_micro = xs.shape[0]
    xs = collectives.copy_to(xs, group)
    first = torch.tensor(s == 0, device=xs.device)
    last = float(s == n - 1)
    total = n_micro + n - 1
    state, outs = xs[0], []
    for t in range(total):
        h = torch.where(first, xs[min(t, n_micro - 1)], state)
        y = stage_fn(h, min(max(t - s, 0), n_micro - 1))
        if t >= n - 1:
            outs.append(y * last)
        if t < total - 1:
            (state,) = collectives.shift([y], group, 1)
    return collectives.reduce_from(torch.stack(outs), group)


def pipeline_apply(layer_fn: Callable[[Any, torch.Tensor], torch.Tensor], stacked_params: Any,
                   xs: torch.Tensor, group=None) -> torch.Tensor:
    """Run microbatches ``xs`` ``(n_micro, micro_batch, ...)`` (every rank
    holds them) through a layer stack pipelined over ``group``.

    ``layer_fn(one_layer_params, x)`` applies one layer; ``stacked_params``
    has the layer axis leading on every tensor (``stack_layer_params``),
    its length divisible by the group size: each stage runs its block of
    consecutive layers. Returns the ``(n_micro, micro_batch, ...)`` outputs
    on every rank."""
    n, s = collectives.size(group), collectives.rank(group)
    leaf = next(iter(stacked_params.values())) if isinstance(stacked_params, dict) \
        else stacked_params
    n_layers = leaf.shape[0]
    if n_layers % n:
        raise ValueError(f"n_layers={n_layers} not divisible by pipe={n}")
    per = n_layers // n
    local = [_layer(stacked_params, j) for j in range(s * per, (s + 1) * per)]

    def stage(h, mb):
        for p in local:
            h = layer_fn(p, h)
        return h

    return _gpipe(stage, xs, group)


def pipeline_module_stack(apply_fn: Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor],
                          x: torch.Tensor, masks: Optional[torch.Tensor], group,
                          n_micro: int) -> torch.Tensor:
    """GPipe a module stack over ``group``: ``apply_fn(h, masks_mb)``
    applies this stage's layers to a microbatch and its (micro_batch, T)
    masks (None without masks). ``x`` (B, ...) splits into ``n_micro``
    microbatches; B must divide by ``n_micro`` (the trainer pads a batch
    to that multiple, as the JAX trainer does). Returns the (B, ...)
    output on every rank."""
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
    xs = x.reshape(n_micro, B // n_micro, *x.shape[1:])
    ms = None if masks is None else masks.reshape(n_micro, B // n_micro, *masks.shape[1:])
    out = _gpipe(lambda h, mb: apply_fn(h, None if ms is None else ms[mb]), xs, group)
    return out.reshape(B, *out.shape[2:])


__all__ = ["pipeline_apply", "pipeline_module_stack", "stack_layer_params"]
