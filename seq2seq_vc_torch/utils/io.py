"""HDF5, dump-directory and statistics I/O (mirrors
seq2seq_vc_tpu/utils/io.py:24-59).

``h5py`` is imported only when an HDF5 file is read or written, and its
absence raises then. Statistics (``<feat>_mean``, ``<feat>_scale``, or
``mean``, ``scale`` for a vocoder) are read from an ``.h5`` file or from an
``.npz`` with the same keys, which needs no ``h5py``.

Kaldi binary arks (``read_kaldi_matrix``, ``write_kaldi_ark``; copies of
seq2seq_vc_tpu/utils/io.py:142-191) hold uncompressed float32 (``FM``) or
float64 (``DM``) matrices addressed by ``<ark>:<offset>`` scp values, which
``train/data.KaldiArkScpLoader`` reads.

A dump directory holds per-utterance arrays in one of two formats, the
``format`` key of a recipe's config: ``hdf5`` (``<dumpdir>/<utt>.h5``, one
dataset an array name, what the JAX package's CLIs write) or ``npy``
(``<dumpdir>/<name>/<utt>.npy`` and an scp of them, ``<dumpdir>/<name>.scp``,
what ``train/data.NpyScpLoader`` reads).
"""

from __future__ import annotations

import fnmatch
import os
from typing import BinaryIO, Dict, List, Optional, Tuple

import numpy as np


FORMATS = ("hdf5", "npy")


def get_basename(path: str) -> str:
    """A path's file name without its extension."""
    return os.path.splitext(os.path.basename(path))[0]


def find_files(root_dir: str, query: str = "*.wav") -> List[str]:
    """Files under ``root_dir`` (recursively) whose names match ``query``."""
    found = []
    for root, _, filenames in os.walk(root_dir, followlinks=True):
        for filename in fnmatch.filter(filenames, query):
            found.append(os.path.join(root, filename))
    return found


def import_h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("HDF5 I/O needs h5py, which is not installed") from e
    return h5py


def read_hdf5(path: str, dset: str) -> np.ndarray:
    """One dataset of an HDF5 file."""
    with import_h5py().File(path, "r") as f:
        if dset not in f:
            raise KeyError(f"no dataset {dset!r} in {path}")
        return f[dset][()]


def write_hdf5(path: str, dset: str, data, is_overwrite: bool = True) -> None:
    """Write one dataset into an HDF5 file, creating it and its directory."""
    data = np.asarray(data)
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    with import_h5py().File(path, "r+" if os.path.exists(path) else "w") as f:
        if dset in f:
            if not is_overwrite:
                raise FileExistsError(f"{dset!r} already in {path}")
            del f[dset]
        f.create_dataset(dset, data=data)


def _stats_keys(feat: Optional[str]):
    prefix = f"{feat}_" if feat else ""
    return {"mean": f"{prefix}mean", "scale": f"{prefix}scale"}


def read_stats(path: str, feat: Optional[str] = None) -> Dict[str, np.ndarray]:
    """{"mean", "scale"} float32 of ``feat`` (``<feat>_mean``, ...; a
    vocoder's plain ``mean``, ``scale`` when ``feat`` is None) from an
    ``.npz`` or an HDF5 file."""
    keys = _stats_keys(feat)
    if path.endswith(".npz"):
        with np.load(path) as f:
            return {k: np.asarray(f[v], np.float32) for k, v in keys.items()}
    return {k: np.asarray(read_hdf5(path, v), np.float32) for k, v in keys.items()}


def write_stats(path: str, mean, scale, feat: Optional[str] = None) -> None:
    """Write statistics as ``read_stats`` reads them: ``.npz`` by suffix,
    else HDF5."""
    keys = _stats_keys(feat)
    arrays = {keys["mean"]: np.asarray(mean), keys["scale"]: np.asarray(scale)}
    if path.endswith(".npz"):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **arrays)
        return
    for dset, data in arrays.items():
        write_hdf5(path, dset, data)


class DumpWriter:
    """Writes per-utterance arrays into a dump directory in ``fmt``
    (``FORMATS``); the ``npy`` scps are written on ``close``. A context
    manager."""

    def __init__(self, dumpdir: str, fmt: str = "hdf5"):
        if fmt not in FORMATS:
            raise ValueError(f"format {fmt!r} is not one of {FORMATS}")
        self.dumpdir, self.fmt = dumpdir, fmt
        self.scps: Dict[str, Dict[str, str]] = {}
        os.makedirs(dumpdir, exist_ok=True)

    def write(self, utt: str, name: str, data) -> None:
        if self.fmt == "hdf5":
            write_hdf5(os.path.join(self.dumpdir, f"{utt}.h5"), name, data)
            return
        path = os.path.abspath(os.path.join(self.dumpdir, name, f"{utt}.npy"))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, np.asarray(data))
        self.scps.setdefault(name, {})[utt] = path

    def close(self) -> None:
        """Each array name's kaldi-style scp, ``<utt_id> <absolute path>`` a
        line, so that it reads from any working directory."""
        for name, entries in self.scps.items():
            with open(os.path.join(self.dumpdir, f"{name}.scp"), "w") as f:
                f.writelines(f"{utt} {path}\n" for utt, path in entries.items())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_kaldi_header(f: BinaryIO) -> Tuple[np.dtype, int, int]:
    """A kaldi binary matrix's header at the file's offset: (dtype, rows,
    cols). The layout kaldi and kaldiio write for an scp-addressed entry:
    a "\\0B" binary marker, an "FM "/"DM " type token, then per dimension a
    size byte (4) and a little-endian int32. Compressed matrices (CM*) are
    not read: re-dump them uncompressed."""
    marker = f.read(2)
    if marker != b"\x00B":
        raise ValueError(f"not a kaldi binary entry (marker {marker!r})")
    token = b""
    while not token.endswith(b" "):
        c = f.read(1)
        if not c:
            raise EOFError("truncated kaldi matrix header")
        token += c
    kind = token.strip().decode()
    if kind not in ("FM", "DM"):
        raise ValueError(f"kaldi matrix type {kind!r} unsupported (only FM/DM; compressed CM "
                         "matrices must be re-dumped uncompressed)")
    dims = []
    for _ in range(2):
        if f.read(1) != b"\x04":
            raise ValueError("unexpected kaldi int size byte")
        dims.append(int.from_bytes(f.read(4), "little", signed=True))
    return np.dtype(np.float32 if kind == "FM" else np.float64), dims[0], dims[1]


def read_kaldi_matrix(f: BinaryIO) -> np.ndarray:
    """The kaldi binary matrix at the file's offset, (rows, cols)."""
    dtype, rows, cols = read_kaldi_header(f)
    data = np.frombuffer(f.read(rows * cols * dtype.itemsize), dtype=dtype)
    return data.reshape(rows, cols)


def write_kaldi_ark(ark_path: str, arrays: Dict[str, np.ndarray]) -> Dict[str, str]:
    """Write a binary kaldi ark of float32 matrices; returns {utt_id:
    "path:offset"}, the scp values that address each entry."""
    scp: Dict[str, str] = {}
    dirname = os.path.dirname(ark_path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    with open(ark_path, "wb") as f:
        for utt, arr in arrays.items():
            arr = np.ascontiguousarray(arr, np.float32)
            f.write(utt.encode() + b" ")
            offset = f.tell()
            f.write(b"\x00BFM ")
            for d in arr.shape:
                f.write(b"\x04" + int(d).to_bytes(4, "little", signed=True))
            f.write(arr.tobytes())
            scp[utt] = f"{ark_path}:{offset}"
    return scp
