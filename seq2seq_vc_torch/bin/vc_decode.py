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
``--data-parallel N`` decodes with N ranks of one process group (``torchrun
--nproc_per_node N``; one card a rank, or ``gloo`` processes with
``--device cpu``), as the JAX driver shards a batch over N devices: each
batch is padded to a multiple of N rows by repeating its last utterance and
each rank decodes its block of rows at the whole batch's padded length,
with the whole batch's draws (the duration noise, the prenet's masks), so
the outputs are those of ``--data-parallel 1``; a diffusion decoder's
sampler draws for the rank's rows alone. Each rank writes its utterances;
rank 0 writes ``feats.scp``. ``--batch-size`` must be a positive multiple of
N, and N at most the cards (the ranks on the CPU). With
``--use-teacher-forcing`` (one utterance a batch) rank r takes every Nth
utterance. Unless
``--skip-plots``, each utterance's features are plotted as
``outs/<utt>.png``, and for the AR path its stop probabilities as
``probs/<utt>_prob.png`` and its attention as ``att_ws/<utt>_att_ws.png``
(teacher forcing: the features and the attention), as the JAX driver
plots them, best-effort (``utils/plot.py``: without ``matplotlib`` a
warning is logged and the decode carries on). A diffusion decoder
(``decoder_type: diffsinger`` or ``prodiff``) samples with the batch's
generator.
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
from ..parallel import initialize_multihost, is_coordinator, rank, world_size
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


def data_parallel_device(device: torch.device, n_dp: int, batch_size: int) -> torch.device:
    """This rank's device for ``--data-parallel n_dp``; raises as the JAX
    driver does for a batch size that is not a positive multiple of n_dp
    and for more ranks than devices (the cards; on the CPU the ranks)."""
    if batch_size < n_dp or batch_size % n_dp:
        raise ValueError("--batch-size must be a positive multiple of --data-parallel")
    device = initialize_multihost(device)
    available = torch.cuda.device_count() if device.type == "cuda" else world_size()
    if n_dp > available:
        raise ValueError(f"--data-parallel {n_dp} > available devices {available}")
    if world_size() != n_dp:
        raise ValueError(f"--data-parallel {n_dp} runs as {n_dp} ranks of one process group "
                         f"(torchrun --nproc_per_node {n_dp}); this group has {world_size()}")
    return device


def rank_positions(n: int, n_dp: int, me: int) -> range:
    """Rank ``me``'s rows of a batch of ``n`` padded to a multiple of n_dp,
    as positions in the padded batch."""
    per = -(-n // n_dp)
    return range(me * per, (me + 1) * per)


def rank_rows(n: int, n_dp: int, me: int):
    """The utterances (indices into the batch) of rank ``me``'s rows: the
    padding repeats the last one."""
    return [min(p, n - 1) for p in rank_positions(n, n_dp, me)]


def duration_noise(model: AASVC, whole, n_frames: int, generator: torch.Generator):
    """The duration predictor's noise of the whole batch (as a run of one
    draws it), at this rank's rows."""
    n, rows = whole
    noise = torch.randn(n, model.text_frames(n_frames), 2, generator=generator,
                        device=generator.device)
    return noise[rows]


def load_model(config: Dict[str, Any], checkpoint: str, device) -> torch.nn.Module:
    """The config's model with a port checkpoint's weights, in eval mode."""
    model = get_model_class(config["model_type"])(**config["model_params"])
    state = torch.load(checkpoint, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"])
    return model.to(device).eval()


def _teacher_forced(model, item, xs, ilens, generator):
    """The VTN's teacher-forced pass on one utterance: (features, durations,
    the cross-attention over the valid frames)."""
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
    att = att[:, :, : int(out["olens_in"][0]), : int(out["ilens_ds_st"][0])]
    durations, focus = calculate_durations(att)
    logging.info("%s: focus rate = %.3f", item["utt_id"], focus)
    return out["after_outs"][0, :n].float().cpu().numpy(), durations, att


def plot_decode(outdir: str, utt: str, feats, probs=None, att_ws=None) -> None:
    """The JAX driver's diagnostic plots of one utterance."""
    from ..utils.plot import plot_1d, plot_2d, plot_attention

    plot_2d(feats, os.path.join(outdir, "outs", f"{utt}.png"))
    if probs is not None:
        plot_1d(probs, os.path.join(outdir, "probs", f"{utt}_prob.png"))
    if att_ws is not None:
        plot_attention(att_ws, os.path.join(outdir, "att_ws", f"{utt}_att_ws.png"))


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
    parser.add_argument("--skip-plots", action="store_true",
                        help="skip mel/attention/stop-prob diagnostic plots")
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup(args.verbose)
    device = resolve_device(args.device)
    n_dp = max(1, int(args.data_parallel))
    if n_dp > 1:
        device = data_parallel_device(device, n_dp, args.batch_size)
    me = rank() if n_dp > 1 else 0
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
    batches = decode_batches(dataset, batch_size)
    utt_order = {dataset.utt_ids[i]: k for k, i in enumerate(sum(batches, []))}
    scp, total_frames, total_sec = [], 0, 0.0
    for n_group, group in enumerate(batches):
        if args.use_teacher_forcing and n_group % n_dp != me:
            continue  # another rank's utterance
        items = [dataset[i] for i in group]
        # this rank's rows of the batch padded to a multiple of n_dp (all of
        # it without teacher forcing at n_dp 1, and for teacher forcing)
        rows = (list(range(len(items))) if args.use_teacher_forcing
                else rank_rows(len(items), n_dp, me))
        xs = torch.as_tensor(pad_batch([it["src_feat"] for it in items], multiple)[rows],
                             device=device)
        ilens = torch.tensor([len(items[i]["src_feat"]) for i in rows], device=device)
        generator = utterance_generator(seed, group[0])
        whole = len(items), torch.tensor(rows)  # the batch's draws, kept at these rows
        real = ([True] if args.use_teacher_forcing
                else [p < len(items) for p in rank_positions(len(items), n_dp, me)])
        items = [items[i] for i in rows]
        durations = [None] * len(items)
        probs = att = [None] * len(items)
        start = time.perf_counter()
        if args.use_teacher_forcing:
            feats, durations[0], att_tf = _teacher_forced(model, items[0], xs, ilens, generator)
            outs, out_lens, att = feats[None], [len(feats)], [att_tf]
        elif is_ar:
            longest = max(len(it["src_feat"]) for it in items)
            drv.model.dprenet.draw_rows = whole if n_dp > 1 else None
            out = drv(xs, ilens, generator, est_steps=drv.expected_steps(longest))
            outs, out_lens = out["outs"].float().cpu().numpy(), out["out_lens"].tolist()
            if not args.skip_plots:  # att_ws (layers, B, heads, T_out / r, T_mem)
                probs = out["probs"].float().cpu().numpy()
                att = out["att_ws"].float().cpu().numpy().swapaxes(0, 1)
        else:
            dp = None
            if "dp_input" in items[0]:
                dp = torch.as_tensor(pad_batch([it["dp_input"] for it in items], multiple),
                                     device=device)
            # only AAS-VC draws (its duration noise); FastSpeech-VC takes no generator
            noise = {"generator": generator} if isinstance(model, AASVC) else {}
            if noise and n_dp > 1:
                noise["noise"] = duration_noise(model, whole, xs.shape[1], generator)
            out = model.inference(xs, ilens, dp, max_output_frames=2 * xs.shape[1], **noise)
            outs, out_lens = out["outs"].float().cpu().numpy(), out["out_lens"].tolist()
            d_outs, d_lens = out["d_outs"].cpu().numpy(), out["d_lens"].tolist()
            durations = [d_outs[b, :n].astype(np.int64) for b, n in enumerate(d_lens)]
        elapsed = time.perf_counter() - start
        total_frames += sum(out_lens)
        total_sec += elapsed
        logging.info("batch of %d: %d frames in %.3f s (%.1f frames/sec)", len(items),
                     sum(out_lens), elapsed, sum(out_lens) / max(elapsed, 1e-9))
        for it, feats, n, dur, prob, aw, ok in zip(items, outs, out_lens, durations, probs, att,
                                                   real):
            if not ok:  # a repeated row that pads the batch
                continue
            utt = it["utt_id"]
            path = os.path.join(args.outdir, f"{utt}.npy")
            np.save(path, feats[:n])
            scp.append(f"{utt} {os.path.abspath(path)}")
            if dur is not None:
                np.savetxt(os.path.join(dur_dir, f"{utt}.txt"), dur[None], fmt="%d")
            if not args.skip_plots:
                plot_decode(args.outdir, utt, feats[:n], None if prob is None else prob[:n], aw)
            write_wav(os.path.join(wav_dir, f"{utt}.wav"), vocoder.decode(feats[:n]), vocoder.fs)
    if n_dp > 1:  # every rank's lines, in the order of a run of one
        gathered = [None] * world_size()
        torch.distributed.all_gather_object(gathered, scp)
        scp = sorted(sum(gathered, []), key=lambda line: utt_order[line.split(" ", 1)[0]])
    if is_coordinator():
        with open(os.path.join(args.outdir, "feats.scp"), "w") as f:
            f.write("\n".join(scp) + "\n")
    rate = total_frames / max(total_sec, 1e-9)
    logging.info("decode finished: %d frames in %.3f s (avg %.1f mel-frames/sec)",
                 total_frames, total_sec, rate)
    return {"frames": total_frames, "seconds": total_sec, "frames_per_sec": rate}


if __name__ == "__main__":
    main()
