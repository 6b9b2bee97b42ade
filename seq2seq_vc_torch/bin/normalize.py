"""z-normalisation of one feature type of a dump with precomputed
statistics (mirrors seq2seq_vc_tpu/bin/normalize.py:21-54).

    python -m seq2seq_vc_torch.bin.normalize --rootdir dump/train/raw \
        --dumpdir dump/train/norm --stats stats.npz [--feat_type mel] \
        [--config conf.yaml] [--skip-wav-copy] [--device cpu]

Reads ``--feats-scp`` or the dump directory ``--rootdir``, computes
``(x - mean) / scale`` in float32 on the card (unless ``--device`` names
another device) with the ``<feat>_mean`` and ``<feat>_scale`` of
``--stats`` (``.npz`` or ``.h5``), and writes the result, with each
utterance's wave copied unless ``--skip-wav-copy``, in the ``format`` of
``--config`` (``hdf5`` without one, as the JAX CLI writes). The wave comes
from the utterance's ``.h5`` file of a ``hdf5`` directory, or from the
``wave.scp`` beside the features of an ``npy`` dump. ``main`` returns the
utterance count.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from ..core.config import load_config
from ..device import resolve_device
from ..train.data import NpyScpLoader, dump_loader
from ..utils.io import DumpWriter, read_hdf5, read_stats
from . import setup


def wave_source(loader, src: str, fmt: str):
    """utt_id -> wave (or None) for the dump the features come from."""
    if hasattr(loader, "mapping"):  # a directory of .h5 files
        def from_h5(utt):
            try:
                return read_hdf5(loader.mapping[utt], "wave")
            except KeyError:
                return None
        return from_h5
    scp = os.path.join(src if os.path.isdir(src) else os.path.dirname(src), "wave.scp")
    if fmt == "npy" and os.path.isfile(scp):
        waves = NpyScpLoader(scp)
        return lambda utt: waves[utt] if utt in waves.data else None
    return lambda utt: None


def main(argv=None):
    parser = argparse.ArgumentParser(description="Normalize dumped features (PyTorch port)")
    parser.add_argument("--rootdir", default=None)
    parser.add_argument("--feats-scp", "--scp", default=None)
    parser.add_argument("--dumpdir", required=True)
    parser.add_argument("--stats", required=True)
    parser.add_argument("--feat_type", default="mel")
    parser.add_argument("--config", default=None, help="its `format` (default hdf5)")
    parser.add_argument("--skip-wav-copy", action="store_true")
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup(args.verbose)
    device = resolve_device(args.device)
    fmt = load_config(args.config).get("format", "hdf5") if args.config else "hdf5"
    src = args.feats_scp or args.rootdir
    if src is None:
        raise ValueError("either --feats-scp or --rootdir is required")
    loader = dump_loader(src, args.feat_type, fmt)
    stats = read_stats(args.stats, args.feat_type)
    mean, scale = (torch.as_tensor(stats[k], device=device) for k in ("mean", "scale"))
    wave = wave_source(loader, src, fmt)

    with DumpWriter(args.dumpdir, fmt) as dump:
        for utt in loader.keys():
            x = torch.as_tensor(loader[utt], device=device)
            dump.write(utt, args.feat_type, ((x - mean) / scale).cpu().numpy().astype(np.float32))
            w = None if args.skip_wav_copy else wave(utt)
            if w is not None:
                dump.write(utt, "wave", w)
    logging.info("normalised %s of %d utterances into %s", args.feat_type, len(loader.keys()),
                 args.dumpdir)
    return {"utterances": len(loader.keys())}


if __name__ == "__main__":
    main()
