"""One rank of the torchrun groups of tests/test_torch_model_parallel.py
(the port only: no JAX).

    python -m torch.distributed.run --standalone --nproc_per_node N \
        tests/_torch_mp_worker.py JOBS.json

JOBS.json lists the jobs that every rank runs in turn, in one process
group:

- ``{"kind": "vc_train" | "tts_train", "argv": [...], "out": OUT.json}``:
  the entry point's ``main``; rank 0 writes the trainer's history to OUT
  and every rank its parameter count to ``OUT.rank<R>.params`` and the
  parameters it holds to ``OUT.rank<R>.pt``;
- ``{"kind": "ring", "in": IN.npz, "out": OUT.npz}``: the port's
  ``ring_attention`` (causal, and key-masked) and ``ring_rel_attention``
  over the world as one seq group, on IN's whole-sequence inputs (each rank
  its block of positions); rank 0 writes the outputs and the input
  gradients of ``sum(out * dy)``, gathered;
- ``{"kind": "pipeline", "in": IN.npz, "out": OUT.npz}``: ``pipeline_apply``
  of ``tanh(x @ w)`` layers over the world as one pipe group; rank 0
  writes the outputs and the gradients of ``sum(out * dy)``.
"""

import json
import sys

import numpy as np
import torch
import torch.distributed as dist


def _group():
    dist.init_process_group("gloo") if not dist.is_initialized() else None
    return dist.new_group(list(range(dist.get_world_size())))


def _leaf(a):
    return torch.from_numpy(a).requires_grad_(True)


def ring(job):
    from seq2seq_vc_torch.parallel import collectives
    from seq2seq_vc_torch.parallel.ring_attention import ring_attention, ring_rel_attention

    g = _group()
    data = dict(np.load(job["in"]))
    lens = torch.from_numpy(data["lens"])
    out = {}

    def block(name):
        return _leaf(np.ascontiguousarray(collectives.block(torch.from_numpy(data[name]), g, 2)
                                          .numpy()))

    for case in ("causal", "masked", "rel"):
        q, k, v, dy = (block(n) for n in ("q", "k", "v", "dy"))
        dy = dy.detach()
        if case == "rel":
            qv, p = block("qv"), _leaf(data["p"])
            y = ring_rel_attention(q, qv, k, v, p, lens, g)
            leaves = dict(q=q, qv=qv, k=k, v=v)
        else:
            y = ring_attention(q, k, v, None if case == "causal" else lens, g,
                               causal=case == "causal")
            leaves = dict(q=q, k=k, v=v)
        (y * dy).sum().backward()
        out[f"{case}/out"] = collectives.all_gather(y.detach(), g, 2).numpy()
        for name, t in leaves.items():
            out[f"{case}/d{name}"] = collectives.all_gather(t.grad, g, 2).numpy()
        if case == "rel":
            out["rel/dp"] = collectives.all_reduce(p.grad.clone(), g).numpy()
    if dist.get_rank() == 0:
        np.savez(job["out"], **out)


def pipeline(job):
    from seq2seq_vc_torch.parallel import collectives
    from seq2seq_vc_torch.parallel.pp import pipeline_apply, stack_layer_params

    g = _group()
    data = dict(np.load(job["in"]))
    ws, xs = [_leaf(w) for w in data["w"]], _leaf(data["xs"])
    y = pipeline_apply(lambda wj, x: torch.tanh(x @ wj), stack_layer_params(ws), xs, g)
    (y * torch.from_numpy(data["dy"])).sum().backward()
    # a stage's gradient covers its layers alone; the input's is whole on each rank
    dw = collectives.all_reduce(torch.stack([w.grad for w in ws]), g)
    out = {"out": y.detach().numpy(), "dw": dw.numpy(), "dxs": xs.grad.numpy()}
    if dist.get_rank() == 0:
        np.savez(job["out"], **out)


def train(job):
    from seq2seq_vc_torch.bin import tts_train, vc_train

    trainer = (vc_train if job["kind"] == "vc_train" else tts_train).main(job["argv"])
    n = sum(p.numel() for p in trainer.model.parameters())
    with open(f"{job['out']}.rank{trainer.rank}.params", "w") as f:
        f.write(str(n))
    torch.save({k: v.cpu() for k, v in trainer.model.state_dict().items()},
               f"{job['out']}.rank{trainer.rank}.pt")
    if trainer.rank == 0:
        with open(job["out"], "w") as f:
            json.dump(trainer.history, f)


def main():
    with open(sys.argv[1]) as f:
        jobs = json.load(f)
    for job in jobs:
        {"ring": ring, "pipeline": pipeline}.get(job["kind"], train)(job)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
