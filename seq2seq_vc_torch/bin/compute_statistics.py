"""Per-dimension mean and scale of one feature type over a dump
(mirrors seq2seq_vc_tpu/bin/compute_statistics.py:22-55).

    python -m seq2seq_vc_torch.bin.compute_statistics --rootdir dump/train/raw \
        --config conf.yaml --dumpdir stats [--feat_type mel] [--device cpu]

Reads ``--feats-scp`` or the dump directory ``--rootdir`` (in the config's
``format``), takes each utterance's mean and sum of squared deviations in
float64 on the card (unless ``--device`` names another device) and merges
them on the host (``dsp/stats.RunningStats``: population variance, a zero
deviation mapped to 1, as sklearn's ``StandardScaler``). Writes
``<feat>_mean`` and ``<feat>_scale`` (float32) to ``--dumpdir``: a ``.npz``
or ``.h5`` file by its suffix, or, for a directory, ``stats.npz`` under
``format: npy`` and ``stats.h5`` under ``hdf5``. ``main`` returns the path,
the utterance count and the statistics.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from ..core.config import load_config
from ..device import resolve_device
from ..dsp.stats import RunningStats
from ..train.data import dump_loader
from ..utils.io import write_stats
from . import setup


def main(argv=None):
    parser = argparse.ArgumentParser(description="Compute feature statistics (PyTorch port)")
    parser.add_argument("--feats-scp", "--scp", default=None)
    parser.add_argument("--rootdir", default=None)
    parser.add_argument("--config", required=True)
    parser.add_argument("--dumpdir", required=True, help="output .npz/.h5 path or dir")
    parser.add_argument("--feat_type", default="mel")
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup(args.verbose)
    device = resolve_device(args.device)
    fmt = load_config(args.config).get("format", "hdf5")
    src = args.feats_scp or args.rootdir
    if src is None:
        raise ValueError("either --feats-scp or --rootdir is required")
    loader = dump_loader(src, args.feat_type, fmt)

    stats, n_utts = RunningStats(), 0
    for utt in loader.keys():
        x = torch.as_tensor(loader[utt], dtype=torch.float64, device=device)
        x = x.reshape(x.shape[0], -1)
        if x.shape[0] == 0:
            continue
        mean = x.mean(dim=0)
        m2 = ((x - mean) ** 2).sum(dim=0)
        stats.add_moments(x.shape[0], mean.cpu().numpy(), m2.cpu().numpy())
        n_utts += 1

    out = args.dumpdir
    if not out.endswith((".h5", ".npz")):
        os.makedirs(out, exist_ok=True)
        out = os.path.join(out, "stats.npz" if fmt == "npy" else "stats.h5")
    mean, scale = stats.mean.astype(np.float32), stats.scale.astype(np.float32)
    write_stats(out, mean, scale, args.feat_type)
    logging.info("wrote %s statistics of %d utterances to %s", args.feat_type, n_utts, out)
    return {"path": out, "utterances": n_utts, "mean": mean, "scale": scale}


if __name__ == "__main__":
    main()
