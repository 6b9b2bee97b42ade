"""A training run's layout over the mesh: which model-parallel modes a
config asks for and what they refuse, a model laid out over the mesh
(``parallelize``), and what the trainer then does across ranks (``Plan``):
the gradient sums, the clip's global norm, and checkpoints in the
single-process layout.

The modes (``tensor_parallel``, ``sequence_parallel``,
``pipeline_parallel`` in the config, with ``pipeline_microbatches``) map
to the mesh's model, seq and pipe axes; the data axis takes the rest of
the world (mirrors seq2seq_vc_tpu/bin/vc_train.py:167-277). Sequence and
pipeline parallelism act on the conformer stacks (AAS-VC, FastSpeech-VC),
tensor parallelism on every attention and feed-forward the rules of
``parallel/tp.py`` match.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterable, List, Sequence

import torch

from . import collectives, tp
from .mesh import Mesh, all_reduce_gradients, broadcast_parameters, world_size


def layout(config: Dict[str, Any]) -> Dict[str, int]:
    """The mesh sizes and microbatch count a training config asks for;
    raises for the compositions the JAX driver refuses."""
    sizes = {axis: int(config.get(key) or 1) for axis, key in (
        ("model", "tensor_parallel"), ("seq", "sequence_parallel"),
        ("pipe", "pipeline_parallel"))}
    if sizes["pipe"] > 1 and (sizes["model"] > 1 or sizes["seq"] > 1):
        raise ValueError("pipeline_parallel composes with data parallelism only; set "
                         "tensor_parallel/sequence_parallel to 1")
    if sizes["pipe"] > 1 and (config.get("model_params") or {}).get("remat"):
        raise ValueError("pipe_mesh is mutually exclusive with sp_mesh/remat")
    sizes["n_micro"] = (int(config.get("pipeline_microbatches") or 0) or sizes["pipe"]) \
        if sizes["pipe"] > 1 else 1
    return sizes


def log_layout(sizes: Dict[str, int]) -> None:
    """Each mode's line, as the JAX driver logs it."""
    if sizes["model"] > 1:
        logging.info("tensor parallelism: model axis = %d", sizes["model"])
    if sizes["seq"] > 1:
        logging.info("sequence parallelism: seq axis = %d", sizes["seq"])
    if sizes["pipe"] > 1:
        logging.info("pipeline parallelism: pipe axis = %d (%d microbatches)", sizes["pipe"],
                     sizes["n_micro"])


def _conformers(model: torch.nn.Module):
    from ..nn.conformer import ConformerEncoder

    return [(n, m) for n, m in model.named_modules() if isinstance(m, ConformerEncoder)]


def check_model(model: torch.nn.Module, sizes: Dict[str, int]) -> None:
    """Raise where the JAX package raises for this model under ``sizes``
    (before any process group is needed)."""
    from ..nn.attention import LegacyRelPositionMultiHeadedAttention

    stacks = _conformers(model)
    for axis, key in (("seq", "sequence_parallel"), ("pipe", "pipeline_parallel")):
        if sizes[axis] > 1 and not stacks:
            raise ValueError(f"{key} acts on conformer stacks; {type(model).__name__} has none "
                             "(the JAX model takes no sp_mesh/pipe_mesh)")
    if sizes["seq"] > 1:
        if type(model).__name__ == "FastSpeechVC" and len(stacks) < 2:
            raise NotImplementedError("sequence_parallel requires conformer encoder and decoder")
        for _, enc in stacks:
            att = enc.encoders[0].self_attn
            if isinstance(att, LegacyRelPositionMultiHeadedAttention):
                raise NotImplementedError("sequence_parallel supports the new-style rel-pos "
                                          "attention only (conformer_rel_pos_type: latest)")
            if getattr(att, "zero_triu", False):
                raise NotImplementedError("sequence_parallel does not take zero_triu")
            if att.n_head % sizes["model"]:
                raise ValueError(f"aheads ({att.n_head}) must divide by the mesh model axis "
                                 f"({sizes['model']}) when sequence_parallel is on")
    if sizes["pipe"] > 1:
        for _, enc in stacks:
            if len(enc.encoders) % sizes["pipe"]:
                raise ValueError(f"n_layers={len(enc.encoders)} not divisible by "
                                 f"pipe={sizes['pipe']}")


class Plan:
    """What a rank holds of the model and what it sums with whom.

    ``splits``: tensor-parallel parameters (name -> split dim);
    ``partial``: replicated parameters summed over the model group;
    ``seq_params``: the sequence-parallel stacks' parameters, summed over
    the seq group; ``stage``: the name prefixes of this pipeline stage's
    layers; ``trainable``: the whole model's parameters that the
    optimizer steps, in order (the single-process optimizer's indices)."""

    def __init__(self, mesh: Mesh, n_micro: int, trainable: List[str]):
        self.mesh, self.n_micro, self.trainable = mesh, n_micro, trainable
        self.splits: Dict[str, int] = {}
        self.partial: List[str] = []
        self.seq_params: List[str] = []
        self.stage: List[str] = []

    @property
    def model_parallel(self) -> bool:
        """Whether a model replica spans several ranks."""
        return any(self.mesh.shape[a] > 1 for a in ("model", "seq", "pipe"))

    def _staged(self, name: str) -> bool:
        return any(name.startswith(p) for p in self.stage)

    # ------------------------------------------------------------ gradients
    def reduce_gradients(self, model: torch.nn.Module) -> None:
        """Sum the gradients: all over the data group, the sequence-parallel
        stacks' over the seq group, the partly used replicated ones over
        the model group."""
        params = dict(model.named_parameters())
        all_reduce_gradients(params.values(), self.mesh.groups["data"])
        all_reduce_gradients([params[n] for n in self.seq_params], self.mesh.groups["seq"])
        all_reduce_gradients([params[n] for n in self.partial], self.mesh.groups["model"])

    def global_norm(self, names: Sequence[str], grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole model's gradient norm: each rank's squares of its
        slices and stage parameters, summed over the model and pipe groups,
        and of each replicated parameter once (on the rank at 0 of both)."""
        owner = float(self.mesh.coords["model"] == 0 and self.mesh.coords["pipe"] == 0)
        weights = [1.0 if n in self.splits or self._staged(n) else owner for n in names]
        norms = torch.stack(torch._foreach_norm(list(grads))).float()
        sq = (norms * norms * torch.tensor(weights, device=norms.device)).sum()
        for axis in ("model", "pipe"):
            collectives.all_reduce(sq, self.mesh.groups[axis])
        return sq.sqrt()

    # ---------------------------------------------------------- checkpoints
    def full_state(self, model: torch.nn.Module, optimizer) -> Dict[str, Any]:
        """The model's and the optimizer's state in the single-process
        layout, on every rank (a collective: every rank calls it)."""
        sd = model.state_dict()
        opt = optimizer.state_dict()
        adam = opt["adam"]
        local = [n for n, p in model.named_parameters() if p.requires_grad]
        per_name = {local[i]: dict(st) for i, st in adam["state"].items()}
        g = self.mesh.groups["model"]
        for name, dim in self.splits.items():
            sd[name] = collectives.all_gather(sd[name], g, dim)
            for key, v in per_name.get(name, {}).items():
                if torch.is_tensor(v) and v.dim():
                    per_name[name][key] = collectives.all_gather(v, g, dim)
        if self.mesh.groups["pipe"] is not None:
            mine = ({k: v.cpu() for k, v in sd.items() if self._staged(k)},
                    {n: {k: v.cpu() if torch.is_tensor(v) else v for k, v in st.items()}
                     for n, st in per_name.items() if self._staged(n)})
            for params, states in collectives.all_gather_object(mine, self.mesh.groups["pipe"]):
                sd.update(params)
                per_name.update(states)
        order = {n: i for i, n in enumerate(self.trainable)}
        groups = [dict(adam["param_groups"][0], params=list(range(len(self.trainable))))]
        state = {order[n]: st for n, st in per_name.items()}
        return {"model": sd, "optimizer": dict(opt, adam={"state": state,
                                                         "param_groups": groups})}

    def local_state(self, model: torch.nn.Module, full: Dict[str, Any],
                    load_only_params: bool) -> Dict[str, Any]:
        """This rank's part of a checkpoint in the single-process layout
        (for ``TrainState.load_state_dict``)."""
        out = {"model": {k: self._slice(k, full["model"][k]) for k in model.state_dict()}}
        if not load_only_params:
            adam = full["optimizer"]["adam"]
            local = [n for n, p in model.named_parameters() if p.requires_grad]
            index = {n: i for i, n in enumerate(local)}
            state = {}
            for j, st in adam["state"].items():
                name = self.trainable[int(j)]
                if name in index:
                    state[index[name]] = {k: self._slice(name, v) if torch.is_tensor(v)
                                          and v.dim() else v for k, v in st.items()}
            groups = [dict(adam["param_groups"][0], params=list(range(len(local))))]
            out["optimizer"] = dict(full["optimizer"], adam={"state": state,
                                                             "param_groups": groups})
        return out

    def _slice(self, name: str, t: torch.Tensor) -> torch.Tensor:
        dim = self.splits.get(name)
        if dim is None:
            return t
        n = t.shape[dim] // self.mesh.shape["model"]
        return t.narrow(dim, self.mesh.coords["model"] * n, n).clone()


def parallelize(model: torch.nn.Module, mesh: Mesh, n_micro: int = 1,
                frozen: Iterable[str] = ()) -> Plan:
    """Lay ``model`` (on its device) out over ``mesh`` in place: rank 0's
    weights to every rank, then this rank's slices of the tensor-parallel
    parameters, the sequence-parallel groups on the conformer stacks, and
    this pipeline stage's layers (the others dropped). ``frozen``: the
    parameters the optimizer will leave out (``freeze_mods``). The model
    has passed ``check_model`` (``bin/vc_train.build_state`` calls both)."""
    if world_size() > 1:
        broadcast_parameters(model)
    frozen = set(frozen)
    trainable = [n for n, p in model.named_parameters() if p.requires_grad and n not in frozen]
    plan = Plan(mesh, n_micro, trainable)
    plan.splits, plan.partial = tp.shard_module(model, mesh)
    seq, pipe = mesh.groups["seq"], mesh.groups["pipe"]
    for name, enc in _conformers(model) if seq is not None or pipe is not None else ():
        prefix = f"{name}.encoders." if name else "encoders."
        if seq is not None:
            enc.sp = seq
            for layer in enc.encoders:
                for m in layer.modules():
                    if hasattr(type(m), "sp"):
                        m.sp = seq
            plan.seq_params += [prefix + n for n, _ in enc.encoders.named_parameters()]
        else:
            enc.pipe, enc.n_micro = pipe, n_micro
            per = len(enc.encoders) // mesh.shape["pipe"]
            first = mesh.coords["pipe"] * per
            for j in range(len(enc.encoders)):
                if first <= j < first + per:
                    plan.stage.append(f"{prefix}{j}.")
                else:
                    enc.encoders[j] = torch.nn.Identity()
    return plan


__all__ = ["Plan", "check_model", "layout", "log_layout", "parallelize"]
