"""Data parallelism over ``torch.distributed`` (mirrors the data-parallel
part of seq2seq_vc_tpu/parallel/): the process group
(``distributed.initialize_multihost``), the coordinator rule, the split of
a global batch into this rank's rows, losses normalised by their count over
the global batch, and the gradient sum (``mesh``). Tensor, sequence and
pipeline parallelism are not ported (ROADMAP.md queue 1 item 5)."""

from .distributed import initialize_multihost, rank, world_size
from .mesh import (
    all_reduce_gradients,
    broadcast_parameters,
    data_parallel,
    global_count,
    is_coordinator,
    rank_seed,
    shard_batch,
)

__all__ = ["all_reduce_gradients", "broadcast_parameters", "data_parallel", "global_count", "initialize_multihost",
           "is_coordinator", "rank", "rank_seed", "shard_batch", "world_size"]
