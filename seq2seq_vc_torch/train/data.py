"""Training and decoding data: scp loaders, the parallel and source-only
mel datasets, the NAR and AR collaters and the batching loader (mirrors
seq2seq_vc_tpu/train/data.py and the scp loaders of
seq2seq_vc_tpu/utils/io.py).

Feature storage: an scp of ``.npy`` paths, an scp of HDF5 entries
(``<utt> <file.h5>[:dset[,dset2]]``), an scp of kaldi binary ark entries
(``<utt> <file.ark>:<offset>``, read natively: no kaldiio) or a dump
directory of per-utterance ``.h5`` files. ``h5py`` is imported only when
an HDF5 source is read, and its absence raises then.

Batches are numpy, padded along time to a bucket multiple, built
length-sorted with the batch order shuffled per epoch; the trainer moves
them to the device. ``DataLoader.seek`` puts a resumed run where an
uninterrupted one would be.
"""

from __future__ import annotations

import fnmatch
import logging
import os
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..utils.io import import_h5py, read_hdf5, read_kaldi_header, read_kaldi_matrix


def read_scp(scp_path: str) -> Dict[str, str]:
    """A kaldi-style scp file as an ordered {utt_id: value} dict."""
    data: Dict[str, str] = {}
    with open(scp_path) as f:
        for line in f:
            line = line.strip()
            if line:
                key, value = line.split(maxsplit=1)
                data[key] = value
    return data


class NpyScpLoader:
    """{utt_id: array} over an scp of ``.npy`` paths, loaded lazily."""

    def __init__(self, feats_scp: str):
        self.data = read_scp(feats_scp)

    def keys(self):
        return self.data.keys()

    def __getitem__(self, key: str) -> np.ndarray:
        return np.load(self.data[key])

    def length(self, key: str) -> int:
        """Row count from the file header (memory-mapped, no data read)."""
        return int(np.load(self.data[key], mmap_mode="r").shape[0])


class HDF5ScpLoader(NpyScpLoader):
    """{utt_id: array} over an scp of HDF5 entries; several datasets of one
    entry are concatenated along the feature axis."""

    def __init__(self, feats_scp: str, default_dset: str = "feats"):
        super().__init__(feats_scp)
        self.default_dset = default_dset

    def _split(self, value: str):
        if ":" in value:
            path, dsets = value.split(":", 1)
            return path, dsets.split(",")
        return value, [self.default_dset]

    def __getitem__(self, key: str) -> np.ndarray:
        path, dsets = self._split(self.data[key])
        arrays = [read_hdf5(path, d) for d in dsets]
        arrays = [a.reshape(-1, 1) if a.ndim == 1 else a for a in arrays]
        return arrays[0] if len(arrays) == 1 else np.concatenate(arrays, axis=1)

    def length(self, key: str) -> int:
        path, dsets = self._split(self.data[key])
        with import_h5py().File(path, "r") as f:
            return int(f[dsets[0]].shape[0])


class KaldiArkScpLoader(NpyScpLoader):
    """{utt_id: array} over an scp of kaldi ark entries
    (``path.ark:offset``)."""

    def _open(self, key: str):
        path, offset = self.data[key].rsplit(":", 1)
        f = open(path, "rb")
        f.seek(int(offset))
        return f

    def __getitem__(self, key: str) -> np.ndarray:
        with self._open(key) as f:
            return read_kaldi_matrix(f)

    def length(self, key: str) -> int:
        """Row count from the matrix header (no data read)."""
        with self._open(key) as f:
            return read_kaldi_header(f)[1]


class _DirLoader:
    """{utt_id: array} over a dump directory of per-utterance HDF5 files."""

    def __init__(self, root: str, dset: str):
        files = []
        for d, _, names in os.walk(root, followlinks=True):
            files += [os.path.join(d, n) for n in fnmatch.filter(names, "*.h5")]
        self.mapping = {os.path.splitext(os.path.basename(f))[0]: f for f in sorted(files)}
        self.dset = dset

    def keys(self):
        return self.mapping.keys()

    def __getitem__(self, utt: str) -> np.ndarray:
        return read_hdf5(self.mapping[utt], self.dset)

    def length(self, utt: str) -> int:
        with import_h5py().File(self.mapping[utt], "r") as f:
            return int(f[self.dset].shape[0])


def make_loader(path: str, feat_key: str = "feats"):
    """The loader of an scp file or a dump directory (scp sniffing as the
    JAX package: ``.npy`` values -> numpy, ``.ark:<offset>`` -> kaldi ark,
    anything else -> HDF5)."""
    if os.path.isdir(path):
        return _DirLoader(path, feat_key)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path) as f:
        first = f.readline().split()
    value = first[1] if len(first) > 1 else ""
    if value.endswith(".npy"):
        return NpyScpLoader(path)
    if value.rsplit(":", 1)[0].endswith(".ark"):
        return KaldiArkScpLoader(path)
    return HDF5ScpLoader(path, feat_key)


def dump_loader(path: str, feat_key: str, fmt: str = "hdf5"):
    """The loader of ``feat_key`` in a dump directory of ``fmt`` (the
    ``npy`` format's ``<dir>/<feat_key>.scp``) or in an scp file."""
    if fmt == "npy" and os.path.isdir(path):
        return NpyScpLoader(os.path.join(path, f"{feat_key}.scp"))
    return make_loader(path, feat_key)


class ParallelVCMelDataset:
    """Paired (source, target) features matched by utterance id, with an
    optional duration-predictor input and optional teacher durations
    (``<durations_dir>/<utt>.txt``: integers, as ``vc_decode`` writes
    them)."""

    def __init__(self, src_feats: str, trg_feats: str, dp_feats: Optional[str] = None,
                 feat_key: str = "feats", allow_cache: bool = False,
                 durations_dir: Optional[str] = None):
        self.src = make_loader(src_feats, feat_key)
        self.trg = make_loader(trg_feats, feat_key)
        self.dp = make_loader(dp_feats, feat_key) if dp_feats else None
        self.durations_dir = durations_dir
        src_ids, trg_ids = set(self.src.keys()), set(self.trg.keys())
        common = sorted(src_ids & trg_ids)
        if not common:
            raise ValueError("no common utt ids between source and target")
        if len(common) != len(src_ids) or len(common) != len(trg_ids):
            logging.warning("utt-id mismatch: %d src, %d trg, %d common",
                            len(src_ids), len(trg_ids), len(common))
        self.utt_ids = common
        self._cache: Optional[Dict[int, Any]] = {} if allow_cache else None

    def length(self, idx: int, key: str = "trg_feat") -> int:
        """Sequence length from storage metadata only."""
        loader = self.trg if key == "trg_feat" else self.src
        return loader.length(self.utt_ids[idx])

    def __len__(self):
        return len(self.utt_ids)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        utt = self.utt_ids[idx]
        item: Dict[str, Any] = {
            "utt_id": utt,
            "src_feat": np.asarray(self.src[utt], np.float32),
            "trg_feat": np.asarray(self.trg[utt], np.float32),
        }
        if self.dp is not None:
            item["dp_input"] = np.asarray(self.dp[utt], np.float32)
        if self.durations_dir is not None:
            path = os.path.join(self.durations_dir, f"{utt}.txt")
            item["duration"] = np.loadtxt(path, dtype=np.int64).reshape(-1)
        if self._cache is not None:
            self._cache[idx] = item
        return item


class SourceVCMelDataset:
    """Source features alone, for decoding, with an optional
    duration-predictor input (mirrors the JAX package's
    ``SourceVCMelDataset``)."""

    def __init__(self, src_feats: str, dp_feats: Optional[str] = None, feat_key: str = "feats"):
        self.src = make_loader(src_feats, feat_key)
        self.dp = make_loader(dp_feats, feat_key) if dp_feats else None
        self.utt_ids = sorted(self.src.keys())

    def length(self, idx: int, key: str = "src_feat") -> int:
        return self.src.length(self.utt_ids[idx])

    def __len__(self):
        return len(self.utt_ids)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        utt = self.utt_ids[idx]
        item = {"utt_id": utt, "src_feat": np.asarray(self.src[utt], np.float32)}
        if self.dp is not None:
            item["dp_input"] = np.asarray(self.dp[utt], np.float32)
        return item


def pad_batch(arrays: Sequence[np.ndarray], multiple: int,
              min_len: Optional[int] = None) -> np.ndarray:
    """Stack (T, ...) arrays, zero-padding T up to a multiple of
    ``multiple`` (at least ``min_len`` frames before rounding)."""
    maxlen = max(a.shape[0] for a in arrays)
    if min_len is not None:
        maxlen = max(maxlen, min_len)
    maxlen = -(-maxlen // multiple) * multiple
    out = np.zeros((len(arrays), maxlen) + arrays[0].shape[1:], arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
    return out


class NARVCCollater:
    """NAR VC batch: xs, ilens, ys, olens, utt_ids and, where the dataset
    has them, dp_inputs and dplens, durations and duration_lens. The source
    (and the durations) pad to a multiple of the bucket and of both encoder
    reduction factors, the target to one of the bucket and the decoder
    reduction factor."""

    def __init__(self, pad_multiple: int = 32, encoder_reduction_factor: int = 1,
                 post_encoder_reduction_factor: int = 1, decoder_reduction_factor: int = 1):
        self.src_multiple = int(np.lcm.reduce(
            [pad_multiple, max(encoder_reduction_factor, 1), max(post_encoder_reduction_factor, 1)]
        ))
        self.trg_multiple = int(np.lcm(pad_multiple, max(decoder_reduction_factor, 1)))

    def __call__(self, batch: List[Dict[str, Any]],
                 pad_to: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
        pad_to = pad_to or {}
        xs = [b["src_feat"] for b in batch]
        ys = [b["trg_feat"] for b in batch]
        items: Dict[str, Any] = {
            "xs": pad_batch(xs, self.src_multiple, pad_to.get("src")),
            "ilens": np.array([x.shape[0] for x in xs], np.int32),
            "ys": pad_batch(ys, self.trg_multiple, pad_to.get("trg")),
            "olens": np.array([y.shape[0] for y in ys], np.int32),
            "utt_ids": [b["utt_id"] for b in batch],
        }
        if "dp_input" in batch[0]:
            dps = [b["dp_input"] for b in batch]
            items["dp_inputs"] = pad_batch(dps, self.src_multiple, pad_to.get("src"))
            items["dplens"] = np.array([d.shape[0] for d in dps], np.int32)
        if "duration" in batch[0]:
            ds = [b["duration"] for b in batch]
            items["durations"] = pad_batch(ds, self.src_multiple, pad_to.get("src"))
            items["duration_lens"] = np.array([d.shape[0] for d in ds], np.int32)
        return items


class ARVCCollater:
    """AR VC batch: xs, ilens, ys, olens, stop labels and utt_ids. The target
    pads to a multiple of the bucket and of the decoder reduction factor;
    a target's stop labels are 1 from its last frame on."""

    def __init__(self, pad_multiple: int = 32, reduction_factor: int = 2):
        self.src_multiple = pad_multiple
        self.trg_multiple = int(np.lcm(pad_multiple, reduction_factor))

    def __call__(self, batch: List[Dict[str, Any]],
                 pad_to: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
        pad_to = pad_to or {}
        xs = [b["src_feat"] for b in batch]
        ys = [b["trg_feat"] for b in batch]
        olens = np.array([y.shape[0] for y in ys], np.int32)
        ys = pad_batch(ys, self.trg_multiple, pad_to.get("trg"))
        labels = (np.arange(ys.shape[1])[None, :] >= olens[:, None] - 1).astype(np.float32)
        return {
            "xs": pad_batch(xs, self.src_multiple, pad_to.get("src")),
            "ilens": np.array([x.shape[0] for x in xs], np.int32),
            "ys": ys,
            "olens": olens,
            "labels": labels,
            "utt_ids": [b["utt_id"] for b in batch],
        }


class DataLoader:
    """Length-sorted batches (by ``sort_key`` length) with the batch order
    shuffled every epoch. With ``prefetch > 0`` a background thread
    collates ahead of the step."""

    def __init__(self, dataset, collater: Callable, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False, sort_key: str = "trg_feat",
                 prefetch: int = 2):
        self.dataset = dataset
        self.collater = collater
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.sort_key = sort_key
        self.epoch = 0
        self._rng = np.random.default_rng(seed)
        self._order: Optional[np.ndarray] = None
        self._skip = 0  # batches of the next epoch to leave out (``seek``)

    def _batches(self) -> List[List[int]]:
        if self._order is None:
            lens = [self.dataset.length(i, self.sort_key) for i in range(len(self.dataset))]
            self._order = np.argsort(np.asarray(lens), kind="stable")
        order = self._order
        batches = [list(order[i: i + self.batch_size])
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches = batches[:-1]
        return batches

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def seek(self, epoch: int, batch: int = 0) -> None:
        """Make the next iteration the one of epoch ``epoch`` (counted from
        0), starting at its batch ``batch``: the shuffle draws of the
        epochs before it are made and dropped."""
        while self.epoch < epoch:
            if self.shuffle:
                self._rng.permutation(len(self))
            self.epoch += 1
        self._skip = batch

    def _collate(self, idxs):
        return self.collater([self.dataset[int(i)] for i in idxs])

    def __iter__(self):
        batches = self._batches()
        if self.shuffle:
            batches = [batches[int(i)] for i in self._rng.permutation(len(batches))]
        batches, self._skip = batches[self._skip:], 0
        self.epoch += 1
        if self.prefetch <= 0:
            for b in batches:
                yield self._collate(b)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def produce():
            try:
                for b in batches:
                    q.put(self._collate(b))
            finally:
                q.put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while (item := q.get()) is not sentinel:
            yield item
        t.join()
