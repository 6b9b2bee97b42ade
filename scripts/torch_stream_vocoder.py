#!/usr/bin/env python3
"""Latency of the VTN's 135 s request on one NVIDIA GPU, serial against
streamed vocoding, in turns: what the streamed synthesis costs or saves.

    python3 scripts/torch_stream_vocoder.py [--seconds 135] [--rounds 3]

It builds the port's kernels and ``chip_smoke.py``'s phase-12 converter
(the full-width VTN in float32 with seeded weights, phase 2's HiFi-GAN,
threshold 1.1 and maxlenratio 4.0, so that every decode runs its whole
budget), warms each mode once, then times ``rounds`` turns of three modes
in a rotating order:

- ``serial``: ``convert_batch(..., stream_vocoder=False)``;
- ``padded``: the streamed vocoder as shipped, each prefix synthesised at
  ``_geom_bucket`` of its length under the decode's budget;
- ``unpadded``: the streamed vocoder with each prefix synthesised at its
  own length (``pipeline._geom_bucket`` patched for that run only).

It prints every latency and each mode's median, and the card's name and
power limit. It needs a card and exits at once without one.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seconds", type=float, default=135.0)
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    import chip_smoke as cs
    from seq2seq_vc_torch import pipeline
    from seq2seq_vc_torch.ops import native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    native.build()
    print(f"card: {cs.card_line()}", flush=True)
    shipped = pipeline._geom_bucket
    modes = ("serial", "padded", "unpadded")
    with torch.no_grad():
        conv = pipeline.Wav2WavARConverter(
            cs.vtn_model(seed=20).eval(), cs.build_vocoder(seed=21), cs.stats(1), cs.stats(2),
            dict(cs.FEATS, inference=cs.VTN_INFERENCE))
        audio = cs.clip(args.seconds, 16)

        def run(mode):
            if mode == "unpadded":
                pipeline._geom_bucket = lambda n, cap, base: min(n, cap)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                conv.convert_batch([audio], stream_vocoder=mode != "serial")
                torch.cuda.synchronize()
            finally:
                pipeline._geom_bucket = shipped
            return (time.perf_counter() - t0) * 1e3

        for mode in modes:
            print(f"warm-up {mode}: {run(mode):.1f} ms", flush=True)
        times = {m: [] for m in modes}
        for r in range(args.rounds):
            for mode in modes[r % 3:] + modes[:r % 3]:
                times[mode].append(run(mode))
                print(f"{args.seconds:.1f} s {mode}: {times[mode][-1]:.1f} ms", flush=True)
    print("medians (ms): " + ", ".join(f"{m} {float(np.median(v)):.1f}"
                                       for m, v in times.items()), flush=True)


if __name__ == "__main__":
    main()
