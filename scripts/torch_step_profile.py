#!/usr/bin/env python3
"""Device time of one training step of the PyTorch port, by kernel, on one
NVIDIA GPU: the tool for comparing two checkouts on the same card.

    python3 scripts/torch_step_profile.py [--root DIR] vtn_long aas_960

For each named step it imports ``chip_smoke`` (and through it
``seq2seq_vc_torch``) from ``--root`` (default: this checkout), builds that
checkout's kernels, and drives the step as ``chip_smoke.py``'s phases do,
with their seeds, batch and settings:

- ``vtn_long``: phase 15, ``ARVCTrainer`` on the full-width VTN in bf16, B
  16 at 8200-9200 frames (every encoder layer on kernels 9-11);
- ``aas_512``, ``aas_960``: phase 8's two batches, ``AASVCTrainer`` on the
  full-width AAS-VC flagship in bf16, B 16 at 160-512 and at 480-960
  frames (the fused route: kernels 1 and 3);
- ``aas_pallas``: phase 21, the same flagship with ``rel_scores_bwd:
  pallas`` at 480-960 frames (kernels 1, 4 and 5);
- ``urh_finetune``: phase 27's GAN step, ``urhythmic.HifiganTrainer`` at
  the JAX defaults (the weight-normed HiFi-GAN, the full MPD and MSD in
  bf16), B 8 of seeded 26-frame units and 8320-sample waves (no kernel
  of the port; the kernels are not built for it alone).

One warm-up step, 3 timed steps, then one profiled step: the device busy
time (kernel time under ``torch.profiler``), the busy share of the
untraced step and the top kernels (``chip_smoke.profile_step``). To compare
two commits, unpack one into a git-ignored directory and run the script
against both roots in one call, in turns (parent, change, change, parent).
It needs a card and exits at once without one.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

PORT_KERNELS = {
    "vtn_long": ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"),
    "aas_512": ("rel_scores_fwd_kernel", "rel_scores_bwd_kernel"),
    "aas_960": ("rel_scores_fwd_kernel", "rel_scores_bwd_kernel"),
    "aas_pallas": ("rel_scores_fwd_kernel", "rel_scores_bwd_dqv_kernel",
                   "rel_scores_bwd_dpos_kernel"),
    "urh_finetune": (),
}
# (lo, hi) target frames of each AAS-VC batch, its corpus seed, the
# flagship's seed and settings (as chip_smoke.py's phases 8 and 21)
AAS = {"aas_512": ((160, 512), 512, 3, {}),
       "aas_960": ((480, 960), 960, 3, {}),
       "aas_pallas": ((480, 960), 960, 47, {"rel_scores_bwd": "pallas"})}


def urh_finetune(cs) -> None:
    """Phase 27's fine-tune step: 1 warm-up, 3 timed, 1 profiled."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from seq2seq_vc_torch.urhythmic.vocoder_train import (BATCH_SIZE, HOP_LENGTH,
                                                          SEGMENT_LENGTH, HifiganTrainer)

    rng = np.random.default_rng(77)
    units = rng.standard_normal((BATCH_SIZE, SEGMENT_LENGTH // HOP_LENGTH, 256)).astype(np.float32)
    wavs = (0.3 * rng.uniform(-1, 1, (BATCH_SIZE, SEGMENT_LENGTH))).astype(np.float32)
    trainer = HifiganTrainer(device="cuda")
    trainer.train_step(units, wavs)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        trainer.train_step(units, wavs)  # ends in a fetch of the losses
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.mean(times))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(units, wavs)
        torch.cuda.synchronize()
    kernels = cs.trace_kernels(prof)
    busy = sum(ms for _, ms, _ in kernels)
    cs.log(f"urh_finetune (B {BATCH_SIZE}, {SEGMENT_LENGTH} samples; root {cs.REPO}): "
           f"untraced steps {[round(t, 1) for t in times]} ms; device busy {busy:.3f} ms in "
           f"{sum(n for *_, n in kernels)} kernel launches, busy share {busy / step_ms:.3f}; "
           f"card {cs.card_line()}")
    for key, ms, n in sorted(kernels, key=lambda r: -r[1])[:12]:
        cs.log(f"  {ms:9.3f} ms {ms / max(busy, 1e-9):6.1%} x{n:<5d} {key[:100]}")


def run(cs, step: str) -> None:
    if step == "urh_finetune":
        return urh_finetune(cs)
    with tempfile.TemporaryDirectory(dir=cs.REPO / "build", prefix=f"step_profile_{step}_") as tmp:
        if step == "vtn_long":
            from seq2seq_vc_torch.train.data import ARVCCollater

            collater = ARVCCollater(cs.PAD_MULTIPLE, cs.VTN_CONFIG["decoder_reduction_factor"])
            loader = cs.corpus_loader(Path(tmp), cs.vtn_long_lens(seed=31), seed=32,
                                      collater=collater)
            model = cs.vtn_model(seed=33, compute_dtype="bfloat16").train()
            make = cs.make_vtn_trainer
        else:
            (lo, hi), seed, model_seed, over = AAS[step]
            loader = cs.corpus_loader(Path(tmp), cs.corpus_lens(lo, hi, seed=seed), seed=seed)
            model = cs.flagship(seed=model_seed, **over)
            make = cs.make_trainer
        state = cs.train_state(model.to(cs.DEVICE))
        cs.train_steps(state, loader, 1, f"{step} warm-up", make=make)
        trainer = cs.train_steps(state, loader, 3, step, make=make)
        step_ms = float(np.mean([h["train/step_time_sec"] for h in trainer.history])) * 1e3
        cs.profile_step(state, loader, step_ms, f"{step}, root {cs.REPO}",
                        port_kernels=PORT_KERNELS[step], make=make)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                        help="checkout whose chip_smoke.py and port to drive")
    parser.add_argument("steps", nargs="+", choices=sorted(PORT_KERNELS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_step_profile: no CUDA device")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)
    import chip_smoke as cs
    from seq2seq_vc_torch.ops import native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (root / "build").mkdir(exist_ok=True)
    if any(PORT_KERNELS[step] for step in args.steps):
        native.build()
    cs.log(f"card: {cs.card_line()}; root {root}")
    for step in args.steps:
        run(cs, step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
