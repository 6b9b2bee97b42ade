"""One rank of the torchrun groups of tests/test_torch_parallel.py (the
port only: no JAX).

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        tests/_torch_ddp_worker.py train OUT.json <vc_train arguments>
    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        tests/_torch_ddp_worker.py decode - <vc_decode arguments>

``train`` runs ``vc_train.main`` and rank 0 writes the trainer's history
(the logged metrics of every step) to OUT.json; ``decode`` runs
``vc_decode.main``. Each leaves the process group when done.
"""

import json
import sys

import torch.distributed as dist


def main():
    mode, out, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
    if mode == "train":
        from seq2seq_vc_torch.bin import vc_train

        trainer = vc_train.main(argv)
        if trainer.rank == 0:
            with open(out, "w") as f:
                json.dump(trainer.history, f)
    else:
        from seq2seq_vc_torch.bin import vc_decode

        vc_decode.main(argv)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
