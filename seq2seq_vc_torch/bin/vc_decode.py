"""VC decoding driver (mirrors seq2seq_vc_tpu/bin/vc_decode.py:41-397).

    python -m seq2seq_vc_torch.bin.vc_decode --dumpdir feats.scp \
        --checkpoint exp/checkpoint-<N>steps.pt --outdir results [--batch-size B]

Reads the training config beside the checkpoint (or ``--config``) and the
target stats, and runs the model per batch of utterances: the NAR path
through ``AASVC.inference`` or ``FastSpeechVC.inference``, the AR path
(VTN) through ``ChunkedARDecoder`` with the config's ``inference`` block,
or, with
``--use-teacher-forcing``, the VTN's teacher-forced pass, whose
cross-attention gives each source frame's duration
(``utils/duration_calculator.py``). Writes each utterance's features as
``<utt>.npy`` (listed in ``feats.scp``), its durations (NAR, teacher
forcing) as ``durations/<utt>.txt`` and its waveform as ``wav/<utt>.wav``
through the config's vocoder (``vocoder/vocoder.py``: Griffin-Lim,
HiFi-GAN, ParallelWaveGAN, MelGAN, StyleMelGAN or the s3prl-vc two-stage
vocoder, whose target stats are ``--trg-stats``' ``<feat-type>_mean`` and
``_scale``, e.g. ``ppg_sxliu``); logs mel-frames/s.

Batches: utterances sorted by source length, ``--batch-size`` at a time,
each padded to its longest item rounded up to ``BUCKET_FRAMES`` (and to the
model's frame stacking), as the JAX driver buckets them. The duration noise
(AAS-VC) and the prenet's dropout (VTN) of a batch come from
``utterance_generator(seed, i)``, ``i`` the index of its first utterance.
``--data-parallel`` is refused (ROADMAP.md queue 1 item 5); the JAX
driver's diagnostic plots are not ported.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from ..core.config import load_config
from ..models import AR_VC_MODELS, get_model_class
from ..models.aas_vc import AASVC
from ..models.ar_driver import ChunkedARDecoder
from ..device import resolve_device
from ..train.data import ParallelVCMelDataset, SourceVCMelDataset, pad_batch
from ..utils.audio import write_wav
from ..utils.duration_calculator import calculate_durations
from ..utils.io import read_stats
from ..vocoder.vocoder import get_vocoder
from . import setup


def utterance_generator(seed: int, idx: int) -> torch.Generator:
    """The CPU generator of the batch whose first utterance is ``idx``."""
    return torch.Generator().manual_seed(seed * 2 ** 32 + idx)


# A length the process has not decoded yet costs the port ~100 ms (an H100
# 80GB HBM3 at 700 W, chip_smoke.py phase 22 without buckets: 144.2 ms an
# utterance on new lengths against 43.3 on lengths seen before), so batches
# pad to buckets, as the JAX driver's do for XLA's compile cache.
BUCKET_FRAMES = 64


def frame_multiple(model) -> int:
    """The frame count a source batch pads to a multiple of: the bucket,
    and for AAS-VC its ``encoder_reduction_factor`` times
    ``post_encoder_reduction_factor`` (the frames it stacks)."""
    stack = (getattr(model, "encoder_reduction_factor", 1)
             * getattr(model, "post_encoder_reduction_factor", 1))
    return int(np.lcm(BUCKET_FRAMES, stack))


def decode_batches(dataset, batch_size: int):
    """The utterance indices of each batch: sorted by source length,
    ``batch_size`` at a time."""
    order = sorted(range(len(dataset)), key=lambda i: (dataset.length(i, "src_feat"), i))
    return [order[g: g + batch_size] for g in range(0, len(order), batch_size)]


def load_model(config: Dict[str, Any], checkpoint: str, device) -> torch.nn.Module:
    """The config's model with a port checkpoint's weights, in eval mode."""
    model = get_model_class(config["model_type"])(**config["model_params"])
    state = torch.load(checkpoint, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"])
    return model.to(device).eval()


def _teacher_forced(model, item, xs, ilens, generator):
    """The VTN's teacher-forced pass on one utterance: (features, durations)."""
    trg = item["trg_feat"]
    r = model.decoder_reduction_factor
    ys = torch.as_tensor(pad_batch([trg], int(np.lcm(BUCKET_FRAMES, r))), device=xs.device)
    labels = torch.zeros(ys.shape[:2], device=xs.device)
    labels[0, len(trg) - 1:] = 1.0
    olens = torch.tensor([len(trg)], device=xs.device)
    with torch.no_grad():
        out = model(xs, ilens, ys, labels, olens, need_att_ws=True, generator=generator)
    n = int(out["olens"][0])
    att = out["att_ws"][:, 0].float().cpu().numpy()  # (layers, heads, T_out / r, T_mem)
    durations, focus = calculate_durations(
        att[:, :, : int(out["olens_in"][0]), : int(out["ilens_ds_st"][0])])
    logging.info("%s: focus rate = %.3f", item["utt_id"], focus)
    return out["after_outs"][0, :n].float().cpu().numpy(), durations


def main(argv=None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(description="Decode with a trained VC model (PyTorch port)")
    parser.add_argument("--dumpdir", required=True, help="source features dir/scp")
    parser.add_argument("--trg-dumpdir", default=None,
                        help="target features (required for --use-teacher-forcing)")
    parser.add_argument("--dp-input-dir", default=None)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--config", default=None, help="defaults to <ckpt_dir>/config.yml")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--trg-stats", default=None)
    parser.add_argument("--feat-type", default="mel")
    parser.add_argument("--use-teacher-forcing", action="store_true")
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--data-parallel", type=int, default=1)
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup(args.verbose)
    device = resolve_device(args.device)
    if args.data_parallel > 1:
        raise NotImplementedError("--data-parallel is not ported yet: ROADMAP.md queue 1 "
                                  "item 5 (the rest: parallel/)")
    config = load_config(args.config or os.path.join(os.path.dirname(args.checkpoint),
                                                     "config.yml"))
    stats_path = args.trg_stats or config.get("trg_stats")
    trg_stats = read_stats(stats_path, args.feat_type) if stats_path else None

    is_ar = config["model_type"] in AR_VC_MODELS
    if args.use_teacher_forcing:
        if not (is_ar and args.trg_dumpdir):
            raise ValueError("--use-teacher-forcing needs an AR model and --trg-dumpdir")
        dataset = ParallelVCMelDataset(args.dumpdir, args.trg_dumpdir,
                                       dp_feats=args.dp_input_dir, feat_key=args.feat_type)
    else:
        dataset = SourceVCMelDataset(args.dumpdir, dp_feats=args.dp_input_dir,
                                     feat_key=args.feat_type)
    logging.info("decoding %d utterances", len(dataset))
    model = load_model(config, args.checkpoint, device)
    vocoder = get_vocoder(config, trg_stats, device)
    drv = ChunkedARDecoder.from_config(model, config.get("inference")) if is_ar else None
    seed = config.get("seed", 0)
    multiple = frame_multiple(model)

    wav_dir, dur_dir = (os.path.join(args.outdir, d) for d in ("wav", "durations"))
    os.makedirs(wav_dir, exist_ok=True)
    os.makedirs(dur_dir, exist_ok=True)
    batch_size = 1 if args.use_teacher_forcing else max(1, args.batch_size)
    scp, total_frames, total_sec = [], 0, 0.0
    for group in decode_batches(dataset, batch_size):
        items = [dataset[i] for i in group]
        xs = torch.as_tensor(pad_batch([it["src_feat"] for it in items], multiple), device=device)
        ilens = torch.tensor([len(it["src_feat"]) for it in items], device=device)
        generator = utterance_generator(seed, group[0])
        durations = [None] * len(items)
        start = time.perf_counter()
        if args.use_teacher_forcing:
            feats, durations[0] = _teacher_forced(model, items[0], xs, ilens, generator)
            outs, out_lens = feats[None], [len(feats)]
        elif is_ar:
            out = drv(xs, ilens, generator, est_steps=drv.expected_steps(int(ilens.max())))
            outs, out_lens = out["outs"].float().cpu().numpy(), out["out_lens"].tolist()
        else:
            dp = None
            if "dp_input" in items[0]:
                dp = torch.as_tensor(pad_batch([it["dp_input"] for it in items], multiple),
                                     device=device)
            # only AAS-VC draws (its duration noise); FastSpeech-VC takes no generator
            noise = {"generator": generator} if isinstance(model, AASVC) else {}
            out = model.inference(xs, ilens, dp, max_output_frames=2 * xs.shape[1], **noise)
            outs, out_lens = out["outs"].float().cpu().numpy(), out["out_lens"].tolist()
            d_outs, d_lens = out["d_outs"].cpu().numpy(), out["d_lens"].tolist()
            durations = [d_outs[b, :n].astype(np.int64) for b, n in enumerate(d_lens)]
        elapsed = time.perf_counter() - start
        total_frames += sum(out_lens)
        total_sec += elapsed
        logging.info("batch of %d: %d frames in %.3f s (%.1f frames/sec)", len(items),
                     sum(out_lens), elapsed, sum(out_lens) / max(elapsed, 1e-9))
        for it, feats, n, dur in zip(items, outs, out_lens, durations):
            utt = it["utt_id"]
            path = os.path.join(args.outdir, f"{utt}.npy")
            np.save(path, feats[:n])
            scp.append(f"{utt} {os.path.abspath(path)}")
            if dur is not None:
                np.savetxt(os.path.join(dur_dir, f"{utt}.txt"), dur[None], fmt="%d")
            write_wav(os.path.join(wav_dir, f"{utt}.wav"), vocoder.decode(feats[:n]), vocoder.fs)
    with open(os.path.join(args.outdir, "feats.scp"), "w") as f:
        f.write("\n".join(scp) + "\n")
    rate = total_frames / max(total_sec, 1e-9)
    logging.info("decode finished: %d frames in %.3f s (avg %.1f mel-frames/sec)",
                 total_frames, total_sec, rate)
    return {"frames": total_frames, "seconds": total_sec, "frames_per_sec": rate}


if __name__ == "__main__":
    main()
