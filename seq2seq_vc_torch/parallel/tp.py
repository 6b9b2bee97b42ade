"""Tensor parallelism: Megatron's column and row splits over the mesh's
``model`` group (mirrors seq2seq_vc_tpu/parallel/tp.py).

The JAX package writes its rules as sharding annotations and lets XLA
insert the collectives. Here each rank holds its slice of the parameters
that the rules split (and their Adam moments, since the optimizer is built
after ``shard_module``), and the split modules issue the collectives
themselves (``parallel/collectives.py``):

- column split (the feed-forward expand ``w_1``, the attention's q/k/v/pos
  projections: heads over ranks): the input enters through ``copy_to``,
  identity forward and gradient sum backward;
- row split (the feed-forward contract ``w_2``, the attention's
  ``linear_out``): the partial product leaves through ``reduce_from``, a sum
  in float32 forward and identity backward, and the bias (replicated) is
  added after it.

``RULES`` lists the splits by the port's parameter names, the JAX rules'
suffixes (``feed_forward``/``feed_forward_macaron``, ``linear_q`` ...) with
torch's leaf names: a column split cuts dim 0 of a weight (Linear ``(out,
in)``, Conv1d ``(out, in, k)``) and of its bias, a row split dim 1 of the
weight. As in JAX, a module whose split dimension does not divide by the
model size stays replicated: a feed-forward whose hidden units do not, an
attention whose heads do not (a rank holds whole heads). The JAX package's
rules match ``Conv1dLinear``'s Dense by its flax name ``Dense_0`` as a
column split; here its ``w_2`` is split by row, the pattern of the other
two kinds, with the same arithmetic.

A replicated parameter that a rank uses only in part (``pos_bias_u`` and
``pos_bias_v``, of which a rank reads its heads' rows) gets its gradient
summed over the model group (``plan.Plan.reduce_gradients``); every other
replicated parameter sits in computation that each rank repeats whole, so
its gradient is already the whole one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from . import collectives
from .mesh import Mesh

COLUMN, ROW = 0, 1
_FF = ("feed_forward", "feed_forward_macaron")
RULES: Tuple[Tuple[Tuple[str, ...], int], ...] = (
    *(rule for ff in _FF for rule in (((ff, "w_1", "weight"), COLUMN),
                                       ((ff, "w_1", "bias"), COLUMN),
                                       ((ff, "w_2", "weight"), ROW))),
    *(((lin, leaf), COLUMN) for lin in ("linear_q", "linear_k", "linear_v")
      for leaf in ("weight", "bias")),
    (("linear_pos", "weight"), COLUMN),
    (("linear_out", "weight"), ROW),
)


def split_dim(name: str) -> Optional[int]:
    """The dim that ``RULES`` split the parameter ``name`` along, or None."""
    keys = tuple(name.split("."))
    for suffix, dim in RULES:
        if keys[-len(suffix):] == suffix:
            return dim
    return None


def _is_attention(module) -> bool:
    from ..nn.attention import MultiHeadedAttention, RelPositionMultiHeadedAttention

    return isinstance(module, (MultiHeadedAttention, RelPositionMultiHeadedAttention))


def _is_feed_forward(name: str, module) -> bool:
    from ..nn.transformer import MultiLayeredConv1d, PositionwiseFeedForward

    return (name.split(".")[-1] in _FF
            and isinstance(module, (PositionwiseFeedForward, MultiLayeredConv1d)))


def shard_module(model: torch.nn.Module, mesh: Mesh) -> Tuple[Dict[str, int], List[str]]:
    """Slice ``model``'s parameters in place under ``RULES`` for this
    rank's place on the model axis and mark the split modules. Returns the
    split parameters (name -> dim) and the replicated parameters whose
    gradients are summed over the model group."""
    group, M, r = mesh.groups["model"], mesh.shape["model"], mesh.coords["model"]
    splits: Dict[str, int] = {}
    partial: List[str] = []
    if M == 1:
        return splits, partial
    for name, module in model.named_modules():
        if _is_attention(module):
            if module.n_head % M:
                continue
            module.n_head //= M
            module.head0 = r * module.n_head
            partial += [f"{name}.{p}" for p in ("pos_bias_u", "pos_bias_v")
                        if hasattr(module, p)]
        elif _is_feed_forward(name, module):
            if module.w_1.weight.shape[0] % M:
                continue
        else:
            continue
        module.tp = group
        for pname, param in module.named_parameters():
            full = f"{name}.{pname}"
            dim = split_dim(full)
            if dim is None:
                continue
            n = param.shape[dim] // M
            param.data = param.data.narrow(dim, r * n, n).clone()
            splits[full] = dim
    return splits, partial


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated input on its way into column-split layers."""
    return collectives.copy_to(x, group)


def row_out(layer, x: torch.Tensor, group) -> torch.Tensor:
    """``layer(x)`` for a layer split by row: the partial product summed
    over ``group``, then the bias."""
    if group is None:
        return layer(x)
    y = collectives.reduce_from(layer(x, bias=False), group)
    return y if layer.bias is None else y + layer.bias.to(y.dtype)


__all__ = ["COLUMN", "ROW", "RULES", "enter", "row_out", "shard_module", "split_dim"]
