"""Parallelism over ``torch.distributed`` (mirrors seq2seq_vc_tpu/parallel/):
the process group (``distributed.initialize_multihost``), the
``(data, model, seq, pipe)`` mesh of groups and data parallelism with
losses over the global batch (``mesh``), the collectives every mode issues
(``collectives``), Megatron tensor parallelism (``tp``), ring attention
(``ring_attention``), GPipe pipeline parallelism (``pp``), and a training
run's layout over the mesh (``plan``: the modes a config asks for, their
refusals, the model laid out, the gradient sums, the global norm and
checkpoints in the single-process layout)."""

from .distributed import initialize_multihost, rank, world_size
from .mesh import (
    Mesh,
    all_reduce_gradients,
    broadcast_parameters,
    data_parallel,
    get_mesh,
    global_count,
    is_coordinator,
    rank_seed,
    shard_batch,
)
from .pp import pipeline_apply, pipeline_module_stack, stack_layer_params
from .ring_attention import ring_attention, ring_rel_attention

__all__ = ["Mesh", "all_reduce_gradients", "broadcast_parameters", "data_parallel", "get_mesh",
           "global_count", "initialize_multihost", "is_coordinator", "pipeline_apply",
           "pipeline_module_stack", "rank", "rank_seed", "ring_attention", "ring_rel_attention",
           "shard_batch", "stack_layer_params", "world_size"]
