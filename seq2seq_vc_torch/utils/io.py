"""HDF5 and statistics I/O (mirrors seq2seq_vc_tpu/utils/io.py:38-59).

``h5py`` is imported only when an HDF5 file is read or written, and its
absence raises then. Statistics (``<feat>_mean``, ``<feat>_scale``, or
``mean``, ``scale`` for a vocoder) are read from an ``.h5`` file, as
``compute_statistics`` writes them, or from an ``.npz`` with the same keys,
which needs no ``h5py``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


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
