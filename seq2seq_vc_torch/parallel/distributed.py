"""The process group of a data-parallel run (mirrors
seq2seq_vc_tpu/parallel/distributed.py, whose ``jax.distributed`` runtime
becomes ``torch.distributed``).

A run of N processes is launched by ``torchrun --nproc_per_node N`` (or any
launcher that sets its environment): ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``. Each process drives one
card, ``cuda:<LOCAL_RANK>``, over NCCL; with ``--device cpu`` the group uses
``gloo``. A process started without that environment is a run of one and
starts no group. Where a node runs more ranks than it has cards
(``LOCAL_WORLD_SIZE`` above the card count), NCCL cannot run, so the group
is ``gloo``, rank ``LOCAL_RANK`` on card ``LOCAL_RANK % cards`` (logged; its
collectives are staged through the host: ``parallel/collectives.py``).
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist


def launched() -> bool:
    """Whether a launcher started this process as one rank of a group."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize_multihost(device) -> torch.device:
    """Join the launcher's process group if there is one and return this
    rank's device: ``device`` itself on the CPU (``gloo``), else the card
    ``cuda:<LOCAL_RANK>`` (``nccl``; ``gloo`` with more ranks than cards on
    the node). Without a launcher (or in a group already started) the
    device is returned as it is."""
    device = torch.device(device)
    if not launched() or dist.is_initialized():
        return device
    if device.type == "cuda":
        local, cards = int(os.environ.get("LOCAL_RANK", 0)), torch.cuda.device_count()
        backend = "nccl"
        if int(os.environ.get("LOCAL_WORLD_SIZE", 1)) > cards:
            backend = "gloo"
            logging.info("%s ranks on a node of %d cards: NCCL takes one rank a card, so the "
                         "group is gloo (collectives staged through the host)",
                         os.environ["LOCAL_WORLD_SIZE"], cards)
        device = torch.device("cuda", local % cards)
        torch.cuda.set_device(device)
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"data parallelism on {device.type} devices is not supported")
    dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    logging.info("process group (%s): rank %d of %d on %s", backend, dist.get_rank(),
                 dist.get_world_size(), device)
    return device


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1
